"""``repro_torch.core.gmm`` against ``repro.core.gmm`` on the same numpy
inputs (CPU), and ``GMM.sample`` checked statistically.

Tolerances: f32 densities rtol/atol 2e-4 (the kernel tests' bound); full
covariance (Cholesky solves in two libraries) rtol/atol 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gmm as jgmm
from repro_torch.convert import gmm_from_numpy, gmm_to_numpy
from repro_torch.core import gmm as tgmm
from repro_torch.core.config import make_generator


def diag_model(rng, k=4, d=5):
    w = rng.dirichlet(np.ones(k)).astype(np.float32)
    mu = rng.normal(0, 3, (k, d)).astype(np.float32)
    var = rng.uniform(0.2, 2.0, (k, d)).astype(np.float32)
    return w, mu, var


def full_model(rng, k=3, d=4):
    w, mu, _ = diag_model(rng, k, d)
    a = rng.normal(0, 1, (k, d, d))
    cov = (a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(d)).astype(np.float32)
    return w, mu, cov


def both(w, mu, cov):
    return (jgmm.GMM(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(cov)),
            gmm_from_numpy(w, mu, cov, device="cpu"))


@pytest.mark.parametrize("kind", ["diag", "full"])
def test_densities_match(kind):
    rng = np.random.default_rng(0)
    w, mu, cov = diag_model(rng) if kind == "diag" else full_model(rng)
    jg, tg = both(w, mu, cov)
    x = rng.normal(0, 3, (200, mu.shape[1])).astype(np.float32)
    tol = 2e-4 if kind == "diag" else 1e-3
    xt = torch.as_tensor(x)
    for name in ("component_log_prob", "log_prob", "responsibilities"):
        np.testing.assert_allclose(
            getattr(tg, name)(xt).numpy(),
            np.asarray(getattr(jg, name)(jnp.asarray(x))), rtol=tol,
            atol=tol, err_msg=name)
    sw = rng.uniform(0, 1, 200).astype(np.float32)
    for name in ("score", "bic"):
        for weight in (None, sw):
            got = getattr(tg, name)(
                xt, None if weight is None else torch.as_tensor(weight))
            exp = getattr(jg, name)(
                jnp.asarray(x), None if weight is None else jnp.asarray(weight))
            np.testing.assert_allclose(float(got), float(exp), rtol=tol,
                                       atol=tol, err_msg=name)
    assert tg.n_free_params() == jg.n_free_params()
    assert tg.is_diagonal == jg.is_diagonal
    assert (tg.n_components, tg.n_features) == (jg.n_components,
                                                jg.n_features)


def test_merge_matches():
    rng = np.random.default_rng(1)
    models = [diag_model(rng, k=k) for k in (2, 3, 4)]
    sizes = np.array([100, 50, 250])
    exp = jgmm.merge_gmms([jgmm.GMM(*map(jnp.asarray, m)) for m in models],
                          jnp.asarray(sizes))
    got = tgmm.merge_gmms([gmm_from_numpy(*m, device="cpu") for m in models],
                          sizes)
    for g, e in zip(gmm_to_numpy(got), (exp.weights, exp.means, exp.covs)):
        np.testing.assert_allclose(g, np.asarray(e), rtol=1e-6, atol=1e-7)
    stacked = [np.stack(a) for a in zip(*(diag_model(rng) for _ in range(3)))]
    exp = jgmm.merge_gmms_stacked(*map(jnp.asarray, stacked),
                                  jnp.asarray(sizes))
    got = tgmm.merge_gmms_stacked(*map(torch.as_tensor, stacked), sizes)
    for g, e in zip(gmm_to_numpy(got), (exp.weights, exp.means, exp.covs)):
        np.testing.assert_allclose(g, np.asarray(e), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["diag", "full"])
def test_sample_moments(kind):
    """Sample mean and covariance of 200k draws against the mixture's own.
    The bound is 6 standard errors of a mean (per coordinate, from the
    mixture variance) and 5% of the largest covariance entry."""
    rng = np.random.default_rng(2)
    w, mu, cov = diag_model(rng) if kind == "diag" else full_model(rng)
    _, tg = both(w, mu, cov)
    n = 200_000
    s = tg.sample(make_generator(3), n).numpy().astype(np.float64)
    assert s.shape == (n, mu.shape[1]) and np.isfinite(s).all()
    full_cov = np.stack([np.diag(c) for c in cov]) if kind == "diag" else cov
    mean = (w[:, None] * mu).sum(0)
    second = (w[:, None, None] * (full_cov + mu[:, :, None]
                                  * mu[:, None, :])).sum(0)
    mix_cov = second - np.outer(mean, mean)
    se = np.sqrt(np.diag(mix_cov) / n)
    assert np.all(np.abs(s.mean(0) - mean) < 6 * se)
    np.testing.assert_allclose(np.cov(s.T), mix_cov,
                               atol=0.05 * np.abs(mix_cov).max())


def test_sample_component_frequencies():
    """Which component each draw comes from follows the weights: with
    well-separated unit-variance components, the nearest mean identifies
    it; chi-square over 50k draws stays below the 0.999 quantile."""
    w = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    mu = (np.arange(4)[:, None] * 50.0 * np.ones((4, 2))).astype(np.float32)
    tg = gmm_from_numpy(w, mu, np.ones((4, 2), np.float32), device="cpu")
    s = tg.sample(make_generator(4), 50_000).numpy()
    comp = np.argmin(((s[:, None, :] - mu[None]) ** 2).sum(-1), axis=1)
    counts = np.bincount(comp, minlength=4)
    expected = w * len(s)
    chi2 = ((counts - expected) ** 2 / expected).sum()
    assert chi2 < 16.27  # chi-square, 3 dof, 0.999 quantile


def test_to_and_member_views():
    rng = np.random.default_rng(5)
    stacked = [np.stack(a) for a in zip(*(diag_model(rng) for _ in range(2)))]
    g = gmm_from_numpy(*stacked, device="cpu")
    assert g.is_diagonal and g.n_components == 4
    one = g[1].to("cpu")
    np.testing.assert_array_equal(one.means.numpy(), stacked[1][1])
