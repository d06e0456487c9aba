"""The plain reference against the port at a tiny size: one EM step, the
merge, and the judge's log-likelihood against the port's own scoring."""
import numpy as np
import pytest
import torch

from perfbench import reference as ref


def _problem(seed=0, n=400, d=5, k=3):
    g = np.random.default_rng(seed)
    x = torch.as_tensor(g.normal(0, 1, (n, d)), dtype=torch.float32)
    mix = ref.Mixture(torch.as_tensor(g.dirichlet(np.ones(k)),
                                      dtype=torch.float32),
                      torch.as_tensor(g.normal(0, 1, (k, d)),
                                      dtype=torch.float32),
                      torch.as_tensor(g.uniform(0.5, 2.0, (k, d)),
                                      dtype=torch.float32))
    return x, mix


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_em_step_matches_the_port(seed):
    from repro_torch.core.em import em_step
    from repro_torch.core.gmm import GMM
    x, mix = _problem(seed)
    new, ll = em_step(GMM(*mix), x, None, 1e-6, "reference")
    tot, s0, s1, s2, n = ref.stats64(x, mix)
    want = ref.m_step64(s0, s1, s2, n, 1e-6)
    assert float(ll) == pytest.approx(float(tot / n), rel=1e-5)
    for got, exp in zip((new.weights, new.means, new.covs), want):
        assert torch.allclose(got.double(), exp, rtol=1e-4, atol=1e-6)
    prec = ref.Precision("float32")
    p0, p1, p2, pll, pw = ref.e_step(x[None], torch.ones(1, x.shape[0]),
                                     ref.Mixture(*(t[None] for t in mix)),
                                     prec)
    plain = ref.m_step(p0, p1, p2, pw, 1e-6)
    for got, exp in zip(plain, want):
        assert torch.allclose(got[0].double(), exp, rtol=1e-4, atol=1e-6)


def test_judge_scores_as_the_port_does():
    from repro_torch.api import score
    from repro_torch.core.config import FitConfig
    from repro_torch.core.gmm import GMM
    x, mix = _problem(3, n=1000)
    avg, gain, nxt = ref.judge_model(x, mix, 1e-6)
    assert avg == pytest.approx(float(score(
        GMM(*mix), x, config=FitConfig(device="cpu"))),
                                abs=1e-4)
    assert gain > nxt > 0.0


def test_merge_matches_the_port():
    from repro_torch.core.gmm import GMM, merge_gmms
    parts = [_problem(s, k=2 + s)[1] for s in range(3)]
    sizes = [100, 250, 40]
    got = merge_gmms([GMM(*m) for m in parts], sizes)
    want = ref.merge(parts, sizes)
    for g, w in zip((got.weights, got.means, got.covs), want):
        assert torch.allclose(g.double(), w, rtol=1e-6, atol=1e-7)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, 3.0e-5, -7.25])
    r = ref.to_tf32(t)
    assert r[0] == t[0] and r[1] == 1.0 and r[3] == t[3]
    assert abs(float(r[2]) / 3.0e-5 - 1.0) < 2.0 ** -10


def test_synthetic_rows_of_the_mixture_pass_the_z_check():
    _, mix = _problem(4, d=6, k=4)
    gen = torch.Generator().manual_seed(0)
    comp = torch.multinomial(mix.weights, 50000, True, generator=gen)
    s = mix.means[comp] + mix.covs[comp].sqrt() * torch.randn(
        (50000, 6), generator=gen)
    assert ref.synth_z(s, ref.merge([mix], [1])) < 5.0
    assert ref.synth_z(s[s[:, 0] > mix.means[0, 0]],
                       ref.merge([mix], [1])) > 20.0
