"""Port kernels against the JAX package: ``repro_torch.kernels`` (ops and
plain versions) vs ``repro.kernels.ref`` on the kernel test shapes, and vs
``repro.kernels.ops`` in interpret mode on two small shapes (the Pallas
path with its padding and packing). On CPU tensors the port's wrappers run
their plain versions; the kernel launches are tested in
``test_torch_cuda.py``.

Tolerances are those of tests/test_kernels.py: log densities rtol/atol
2e-4; E-step s0 rtol 1e-3/atol 1e-4, s1/s2 rtol 1e-3/atol 1e-3, ll rtol
1e-4; assignments equal wherever the two nearest centers are more than
1e-4 apart, distances rtol/atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

# one compiled program per shape instead of one dispatch per jnp op
jax_logpdf = jax.jit(jref.gmm_logpdf_ref)
jax_estep = jax.jit(jref.estep_stats_ref)
jax_assign = jax.jit(jref.kmeans_assign_ref)

SHAPES = [  # (N, d, K), as tests/test_kernels.py
    (64, 4, 2),
    (256, 24, 30),
    (1000, 11, 15),
    (513, 84, 10),
    (100, 38, 10),
    (2048, 128, 64),
    (17, 3, 1),
]


def make_inputs(rng, n, d, k):
    x = rng.normal(0, 2, (n, d)).astype(np.float32)
    mu = rng.normal(0, 2, (k, d)).astype(np.float32)
    var = rng.uniform(0.05, 3.0, (k, d)).astype(np.float32)
    lw = np.log(rng.dirichlet(np.ones(k))).astype(np.float32)
    return x, mu, var, lw


def t(a):
    return torch.as_tensor(a)


def assert_assign(idx, d2, x, centers, eidx, ed2):
    """Equal indices wherever the nearest two centers are > 1e-4 apart."""
    np.testing.assert_allclose(d2, ed2, rtol=1e-4, atol=1e-4)
    dist = np.maximum((x * x).sum(1, keepdims=True) - 2 * x @ centers.T
                      + (centers * centers).sum(1)[None], 0)
    part = np.sort(dist, axis=1)
    clear = (part[:, 1] - part[:, 0] > 1e-4) if dist.shape[1] > 1 \
        else np.ones(len(x), bool)
    assert np.all((idx == eidx) | ~clear)


class TestAgainstJaxRef:
    @pytest.mark.parametrize("n,d,k", SHAPES)
    def test_gmm_logpdf(self, n, d, k):
        x, mu, var, lw = make_inputs(np.random.default_rng(n * 31 + d + k),
                                     n, d, k)
        exp = np.asarray(jax_logpdf(jnp.asarray(x), jnp.asarray(mu),
                                    jnp.asarray(var), jnp.asarray(lw)))
        for got in (ops.gmm_logpdf(t(x), t(mu), t(var), t(lw)),
                    ref.gmm_logpdf_ref(t(x), t(mu), t(var), t(lw))):
            np.testing.assert_allclose(got.numpy(), exp, rtol=2e-4,
                                       atol=2e-4)

    @pytest.mark.parametrize("n,d,k", SHAPES)
    def test_estep_stats(self, n, d, k):
        rng = np.random.default_rng(n * 13 + d + k)
        x, mu, var, lw = make_inputs(rng, n, d, k)
        w = rng.uniform(0, 1, n).astype(np.float32)
        exp = jax_estep(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(var),
                        jnp.asarray(lw), jnp.asarray(w))
        for got in (ops.estep_stats(t(x), t(mu), t(var), t(lw), t(w)),
                    ref.estep_stats_ref(t(x), t(mu), t(var), t(lw), t(w))):
            for g, e, rtol, atol in zip(got, exp, (1e-3, 1e-3, 1e-3, 1e-4),
                                        (1e-4, 1e-3, 1e-3, 0.0)):
                np.testing.assert_allclose(g.numpy(), np.asarray(e),
                                           rtol=rtol, atol=atol)

    @pytest.mark.parametrize("n,d,k", SHAPES)
    def test_kmeans_assign(self, n, d, k):
        x, mu, _, _ = make_inputs(np.random.default_rng(n + d * 3 + k * 11),
                                  n, d, k)
        eidx, ed2 = (np.asarray(a) for a in jax_assign(jnp.asarray(x),
                                                        jnp.asarray(mu)))
        for idx, d2 in (ops.kmeans_assign(t(x), t(mu)),
                        ref.kmeans_assign_ref(t(x), t(mu))):
            assert_assign(idx.numpy(), d2.numpy(), x, mu, eidx, ed2)


class TestAgainstPallasInterpret:
    """The Pallas kernels (interpret mode) with their TPU padding against
    the port's unpadded packing."""

    @pytest.mark.parametrize("n,d,k", [(100, 24, 30), (513, 11, 7)])
    def test_all_three(self, n, d, k):
        rng = np.random.default_rng(7 * n + k)
        x, mu, var, lw = make_inputs(rng, n, d, k)
        w = rng.uniform(0, 1, n).astype(np.float32)
        jx, jmu, jvar, jlw = (jnp.asarray(a) for a in (x, mu, var, lw))
        np.testing.assert_allclose(
            ops.gmm_logpdf(t(x), t(mu), t(var), t(lw)).numpy(),
            np.asarray(jops.gmm_logpdf(jx, jmu, jvar, jlw, interpret=True)),
            rtol=2e-4, atol=2e-4)
        got = ops.estep_stats(t(x), t(mu), t(var), t(lw), t(w))
        exp = jops.estep_stats(jx, jmu, jvar, jlw, jnp.asarray(w),
                               interpret=True)
        for g, e, rtol, atol in zip(got, exp, (1e-3, 1e-3, 1e-3, 1e-4),
                                    (1e-4, 1e-3, 1e-3, 0.0)):
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=rtol,
                                       atol=atol)
        idx, d2 = ops.kmeans_assign(t(x), t(mu))
        eidx, ed2 = jops.kmeans_assign(jx, jmu, interpret=True)
        assert_assign(idx.numpy(), d2.numpy(), x, mu, np.asarray(eidx),
                      np.asarray(ed2))


class TestPackedPlainVersions:
    def test_batched_estep_is_per_client(self):
        """The client axis of the E-step equals one call per client."""
        rng = np.random.default_rng(3)
        xs, mus, vars_, lws = zip(*(make_inputs(rng, 50, 5, 4)
                                    for _ in range(3)))
        w = rng.uniform(0, 1, (3, 50)).astype(np.float32)
        got = ops.estep_stats(t(np.stack(xs)), t(np.stack(mus)),
                              t(np.stack(vars_)), t(np.stack(lws)), t(w))
        for c in range(3):
            one = ops.estep_stats(t(xs[c]), t(mus[c]), t(vars_[c]),
                                  t(lws[c]), t(w[c]))
            for g, e in zip(got, one):
                np.testing.assert_allclose(g[c].numpy(), e.numpy(),
                                           rtol=1e-5, atol=1e-5)

    def test_ties_go_to_first_index(self):
        rng = np.random.default_rng(4)
        base = rng.normal(0, 2, (5, 6)).astype(np.float32)
        centers = np.concatenate([base, base])
        x = rng.normal(0, 2, (300, 6)).astype(np.float32)
        idx, _ = ops.kmeans_assign(t(x), t(centers))
        jidx, _ = jref.kmeans_assign_ref(jnp.asarray(x), jnp.asarray(centers))
        assert idx.max() < 5
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))

    def test_unit_weights_default(self):
        x, mu, var, lw = make_inputs(np.random.default_rng(5), 200, 10, 5)
        s0, *_ = ops.estep_stats(t(x), t(mu), t(var), t(lw))
        np.testing.assert_allclose(float(s0.sum()), 200.0, rtol=1e-4)
