"""``repro_torch.core.em.e_step_stats_chunked`` (the reference's
constant-memory E-step, ``repro/core/em.py``), held to the full-batch
``e_step_stats`` as ``tests/test_streaming_em.py`` holds the reference, and
to the reference's own chunked statistics on the same numpy inputs (CPU).

Tolerances: ``tests/test_streaming_em.py``'s (rtol 1e-4, atol 2e-3: float32
sums of 1,000 rows in chunk order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import em as jem
from repro.core.gmm import GMM as JaxGMM
from repro_torch.convert import gmm_from_numpy
from repro_torch.core import em

TOL = dict(rtol=1e-4, atol=2e-3)


def _diag(rng, k, d):
    return (rng.dirichlet(np.ones(k)).astype(np.float32),
            rng.normal(0, 2, (k, d)).astype(np.float32),
            rng.uniform(0.1, 2.0, (k, d)).astype(np.float32))


def _close(a, b):
    for name, u, v in zip(a._fields, a, b):
        np.testing.assert_allclose(np.asarray(u), np.asarray(v), **TOL,
                                   err_msg=f"field {name}")


# dividing (250), non-dividing (333, 64), above N (2048) and 1
@pytest.mark.parametrize("chunk_size", [1, 64, 250, 333, 999, 2048])
def test_chunked_matches_full_batch_and_jax(chunk_size):
    rng = np.random.default_rng(1)
    params = _diag(rng, 5, 7)
    x = rng.normal(0, 2, (1000, 7)).astype(np.float32)
    w = rng.uniform(0, 1, 1000).astype(np.float32)
    gmm = gmm_from_numpy(*params, device="cpu")
    full = em.e_step_stats(gmm, torch.as_tensor(x), torch.as_tensor(w),
                           estep_backend="reference")
    got = em.e_step_stats_chunked(gmm, torch.as_tensor(x),
                                  torch.as_tensor(w), chunk_size=chunk_size,
                                  estep_backend="reference")
    _close(full, got)
    want = jem.e_step_stats_chunked(
        JaxGMM(*map(jnp.asarray, params)), jnp.asarray(x), jnp.asarray(w),
        chunk_size=chunk_size, estep_backend="reference")
    _close(want, got)


def test_full_covariance_chunked():
    rng = np.random.default_rng(2)
    k, d = 3, 4
    a = rng.normal(0, 1, (k, d, d))
    covs = (a @ np.transpose(a, (0, 2, 1)) + 0.7 * np.eye(d)).astype(
        np.float32)
    params = (rng.dirichlet(np.ones(k)).astype(np.float32),
              rng.normal(0, 2, (k, d)).astype(np.float32), covs)
    x = rng.normal(0, 2, (700, d)).astype(np.float32)
    gmm = gmm_from_numpy(*params, device="cpu")
    full = em.e_step_stats(gmm, torch.as_tensor(x))
    got = em.e_step_stats_chunked(gmm, torch.as_tensor(x), chunk_size=128)
    assert got.s2.shape == (k, d, d)
    _close(full, got)
    _close(jem.e_step_stats_chunked(JaxGMM(*map(jnp.asarray, params)),
                                    jnp.asarray(x), chunk_size=128), got)


def test_chunked_fused_backend_matches_reference():
    """On CPU tensors the fused backend runs its kernel's plain version
    chunk by chunk; the statistics are the reference's."""
    rng = np.random.default_rng(3)
    params = _diag(rng, 4, 6)
    x = torch.as_tensor(rng.normal(0, 2, (900, 6)).astype(np.float32))
    gmm = gmm_from_numpy(*params, device="cpu")
    _close(em.e_step_stats(gmm, x, estep_backend="reference"),
           em.e_step_stats_chunked(gmm, x, chunk_size=256,
                                   estep_backend="fused"))
