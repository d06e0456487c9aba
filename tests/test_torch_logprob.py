"""The row log-density entry of the port (``ops.gmm_log_prob``, the fused
``_log_prob_block`` and the scoring functions above it) against the JAX
package on the same numpy inputs (CPU).

On CPU tensors the wrapper runs its plain version (``ref.gmm_log_prob_packed``,
the logsumexp of the packed per-component densities); the kernel launch is
tested in ``test_torch_cuda.py``. JAX's side is the Pallas ``gmm_logpdf``
kernel in interpret mode followed by ``logsumexp``, and its reference
``_log_prob_block``. Tolerances: rtol/atol 2e-4 per log density, as
tests/test_kernels.py; scores and BIC as tests/test_torch_em.py (rtol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import em as jem
from repro.core.gmm import GMM as JaxGMM
from repro.kernels import ops as jops
from repro_torch.core import em
from repro_torch.core.gmm import GMM
from repro_torch.kernels import gmm_logpdf, ops, ref

from test_torch_kernels import SHAPES, make_inputs, t

jax_block = jax.jit(jem._log_prob_block, static_argnames=("backend",))


def jax_log_prob(x, mu, var, lw):
    """logsumexp over components of the Pallas kernel (interpret mode)."""
    lp = jops.gmm_logpdf(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(var),
                         jnp.asarray(lw), interpret=True)
    return np.asarray(jax.scipy.special.logsumexp(lp, axis=1))


def models(mu, var, lw):
    w = np.exp(lw)
    return (JaxGMM(jnp.asarray(w), jnp.asarray(mu), jnp.asarray(var)),
            GMM(t(w), t(mu), t(var)))


@pytest.mark.parametrize("n,d,k", SHAPES)
def test_log_prob_matches_jax(n, d, k):
    x, mu, var, lw = make_inputs(np.random.default_rng(n * 7 + d + k), n, d,
                                 k)
    got = ops.gmm_log_prob(t(x), t(mu), t(var), t(lw))
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_log_prob(x, mu, var, lw),
                               rtol=2e-4, atol=2e-4)
    jg, g = models(mu, var, lw)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_block(jg, jnp.asarray(x), "reference")),
        rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        em._log_prob_block(g, t(x), "fused").numpy(), got.numpy(), rtol=0,
        atol=0)


def hard_case(kind):
    """A row that one very narrow component dominates, or rows far from
    every component (all log densities below -1e4), among ordinary rows."""
    rng = np.random.default_rng(17)
    x, mu, var, lw = make_inputs(rng, 40, 24, 30)
    if kind == "narrow":
        mu[0] = rng.normal(0, 0.3, 24).astype(np.float32)
        var[0] = 1e-3
        x[0] = mu[0]
        x[1] = mu[0] + 0.01
    else:
        x[:3] = np.float32(100.0) * np.sign(rng.normal(size=(3, 24)))
    return x, mu, var, lw


@pytest.mark.parametrize("kind", ["narrow", "far"])
def test_log_prob_hard_rows(kind):
    x, mu, var, lw = hard_case(kind)
    got = ops.gmm_log_prob(t(x), t(mu), t(var), t(lw)).numpy()
    lp = ops.gmm_logpdf(t(x), t(mu), t(var), t(lw)).numpy()
    assert np.isfinite(got).all()
    if kind == "narrow":  # component 0 holds nearly all of row 0's mass
        assert lp[0, 0] - np.delete(lp[0], 0).max() > 30
    else:
        assert lp[:3].max() < -1e4
    np.testing.assert_allclose(got, jax_log_prob(x, mu, var, lw), rtol=2e-4,
                               atol=2e-4)
    jg, _ = models(mu, var, lw)
    np.testing.assert_allclose(
        got, np.asarray(jax_block(jg, jnp.asarray(x), "reference")),
        rtol=2e-4, atol=2e-4)


def test_plain_version_is_logsumexp_of_plain_logpdf():
    x, mu, var, lw = make_inputs(np.random.default_rng(3), 300, 11, 100)
    a, b, c = ops.pack_params(t(mu), t(var), t(lw))
    lp = ref.gmm_logpdf_packed(t(x), a, b, c)
    assert torch.equal(ref.gmm_log_prob_packed(t(x), a, b, c),
                       torch.logsumexp(lp, dim=-1))
    assert torch.equal(gmm_logpdf.gmm_log_prob(t(x), a, b, c),
                       ref.gmm_log_prob_packed(t(x), a, b, c))


@pytest.fixture(scope="module")
def scoring_data():
    """10,000 rows: chunks of 4096 leave a ragged last chunk of 1,808."""
    rng = np.random.default_rng(29)
    x, mu, var, lw = make_inputs(rng, 10000, 12, 8)
    w = rng.uniform(0, 1, 10000).astype(np.float32)
    return x, w, models(mu, var, lw)


@pytest.mark.parametrize("chunk", [None, 4096])
def test_fused_scoring_matches_jax(scoring_data, chunk):
    x, w, (jg, g) = scoring_data
    xt, jx = t(x), jnp.asarray(x)
    lp = em.log_prob_chunked(g, xt, chunk, backend="fused")
    np.testing.assert_allclose(
        lp.numpy(), np.asarray(jem.log_prob_chunked(jg, jx, chunk)),
        rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        float(em.score_streaming(g, xt, t(w), chunk, backend="fused")),
        float(jem.score_streaming(jg, jx, jnp.asarray(w), chunk)),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        float(em.bic_streaming(g, xt, None, chunk, backend="fused")),
        float(jem.bic_streaming(jg, jx, None, chunk)), rtol=1e-4)

