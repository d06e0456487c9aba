"""``repro_torch.core.em`` against ``repro.core.em`` on the same numpy
inputs (CPU). EM is deterministic once its init is fixed, so fits start
from one injected ``init_gmm`` in both packages.

Tolerances: final avg log-likelihood within 1e-4 (DESIGN.md §6's end-to-end
bound); statistics and scores rtol 1e-4 / atol 1e-3 (f32 sums of a few
thousand rows in another order); chunked vs full batch rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import em as jem
from repro.core.config import FitConfig as JaxConfig
from repro.core.gmm import GMM as JaxGMM
from repro_torch.convert import gmm_from_numpy, gmm_to_numpy
from repro_torch.core import em
from repro_torch.core.config import FitConfig

from conftest import planted_gmm_data


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    x, _, mus = planted_gmm_data(rng, n=1200, d=4, k=3, spread=5.0, std=0.6,
                                 min_sep_sigma=6.0)
    w = (rng.uniform(size=len(x)) > 0.2).astype(np.float32)  # 0 = padding
    init_w = np.full(3, 1 / 3, np.float32)
    init_mu = (mus + rng.normal(0, 0.8, mus.shape)).astype(np.float32)
    init_var = np.ones((3, 4), np.float32)
    return x, w, (init_w, init_mu, init_var)


def jax_gmm(params):
    return JaxGMM(*map(jnp.asarray, params))


def full_init(params):
    w, mu, var = params
    return w, mu, np.stack([np.diag(v) for v in var]).astype(np.float32)


@pytest.mark.parametrize("backend,chunk,cov,weighted", [
    ("reference", "auto", "diag", False),
    ("fused", "auto", "diag", True),
    ("reference", 256, "diag", True),
    ("reference", "auto", "full", True),
])
def test_fit_from_injected_init_matches_jax(data, backend, chunk, cov,
                                            weighted):
    x, w, init = data
    init = init if cov == "diag" else full_init(init)
    sw = w if weighted else None
    exp = jem.fit_gmm_cfg(
        jax.random.key(0), jnp.asarray(x), 3,
        JaxConfig(tol=1e-5, max_iter=60, chunk_size=chunk,
                  covariance_type=cov),
        None if sw is None else jnp.asarray(sw), init_gmm=jax_gmm(init))
    got = em.fit_gmm_cfg(
        0, x, 3, FitConfig(backend=backend, tol=1e-5, max_iter=60,
                           chunk_size=chunk, covariance_type=cov,
                           device="cpu"),
        sw, init_gmm=gmm_from_numpy(*init, device="cpu"))
    assert abs(float(got.log_likelihood) - float(exp.log_likelihood)) <= 1e-4
    assert abs(int(got.n_iter) - int(exp.n_iter)) <= 1
    assert bool(got.converged) == bool(exp.converged)
    for g, e in zip(gmm_to_numpy(got.gmm),
                    (exp.gmm.weights, exp.gmm.means, exp.gmm.covs)):
        np.testing.assert_allclose(g, np.asarray(e), rtol=1e-3, atol=1e-3)


def test_stacked_fit_freezes_each_member():
    """A batch of fits equals the fits one by one (vmap semantics): each
    member stops at its own tolerance, keeps its own iteration count, and
    its state is frozen from then on while the others iterate. Overlapping
    mixtures converge slowly, so a member that kept iterating after its
    stop would move by ~1e-3; the bound is atol 1e-5."""
    xs, members = [], []
    for i, spread in enumerate((3.0, 1.5, 1.0)):
        rng = np.random.default_rng(40 + i)
        x, _, mus = planted_gmm_data(rng, n=1200, d=4, k=3, spread=spread,
                                     std=0.6)
        xs.append(x)
        members.append((np.full(3, 1 / 3, np.float32),
                        (mus + rng.normal(0, 1.0, mus.shape)).astype(
                            np.float32), np.ones((3, 4), np.float32)))
    xs = np.stack(xs)
    inits = [np.stack(a) for a in zip(*members)]
    cfg = FitConfig(tol=1e-4, max_iter=200, device="cpu")
    batch = em.fit_gmm_cfg(0, xs, 3, cfg,
                           init_gmm=gmm_from_numpy(*inits, device="cpu"))
    for i in range(3):
        one = em.fit_gmm_cfg(0, xs[i], 3, cfg,
                             init_gmm=gmm_from_numpy(*members[i],
                                                     device="cpu"))
        assert int(batch.n_iter[i]) == int(one.n_iter)
        np.testing.assert_allclose(float(batch.log_likelihood[i]),
                                   float(one.log_likelihood), rtol=1e-6)
        for a, b in zip((batch.gmm.means[i], batch.gmm.covs[i]),
                        (one.gmm.means, one.gmm.covs)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-5)
    assert len(set(int(i) for i in batch.n_iter)) == 3


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_e_step_and_m_step_match(data, cov):
    x, w, init = data
    init = init if cov == "diag" else full_init(init)
    exp = jem.e_step_stats(jax_gmm(init), jnp.asarray(x), jnp.asarray(w),
                           "reference")
    g = gmm_from_numpy(*init, device="cpu")
    backends = ("reference", "fused") if cov == "diag" else ("reference",)
    for backend in backends:
        got = em.e_step_stats(g, torch.as_tensor(x), torch.as_tensor(w),
                              backend)
        for a, b in zip(got, exp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-3)
    m_got = em.m_step(em.SufficientStats(*(torch.tensor(np.asarray(a))
                                           for a in exp)), 1e-6)
    m_exp = jem.m_step(exp, 1e-6)
    for a, b in zip(gmm_to_numpy(m_got),
                    (m_exp.weights, m_exp.means, m_exp.covs)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)


def test_chunked_equals_full_batch(data):
    x, w, init = data
    g = gmm_from_numpy(*init, device="cpu")
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    full = em.e_step_stats(g, xt, wt)
    for chunk in (100, 257, 5000):
        part = em.e_step_stats(g, xt, wt, chunk_size=chunk)
        for a, b in zip(part, full):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-4)
    cfg = FitConfig(tol=1e-5, max_iter=40, device="cpu")
    a = em.fit_gmm_cfg(0, x, 3, cfg, w, init_gmm=g)
    b = em.fit_gmm_cfg(0, x, 3, cfg.replace(chunk_size=128), w, init_gmm=g)
    np.testing.assert_allclose(float(a.log_likelihood),
                               float(b.log_likelihood), rtol=1e-5)


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_label_stats_match(data, cov):
    x, w, _ = data
    rng = np.random.default_rng(3)
    assign = rng.integers(0, 3, len(x)).astype(np.int32)
    exp = jem.label_stats(jnp.asarray(x), jnp.asarray(assign), 3,
                          jnp.asarray(w), cov)
    for chunk in (None, 100):
        got = em.label_stats(torch.as_tensor(x), torch.as_tensor(assign), 3,
                             torch.as_tensor(w), cov, chunk)
        for a, b in zip(got, exp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-3)


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_scoring_matches(data, backend):
    x, w, init = data
    jg, g = jax_gmm(init), gmm_from_numpy(*init, device="cpu")
    xt, wt = torch.as_tensor(x), torch.as_tensor(w)
    for chunk in (None, 128):
        np.testing.assert_allclose(
            em.log_prob_chunked(g, xt, chunk, backend).numpy(),
            np.asarray(jem.log_prob_chunked(jg, jnp.asarray(x), chunk)),
            rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(
            float(em.score_streaming(g, xt, wt, chunk, backend)),
            float(jem.score_streaming(jg, jnp.asarray(x), jnp.asarray(w),
                                      chunk)), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(
            float(em.bic_streaming(g, xt, None, chunk, backend)),
            float(jem.bic_streaming(jg, jnp.asarray(x), None, chunk)),
            rtol=1e-4)
