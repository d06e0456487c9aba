"""``repro_torch.core.kmeans`` against ``repro.core.kmeans`` (CPU).

Lloyd's iterations are deterministic from fixed centers, so
``kmeans(init_centers=...)`` must give the same centers (atol 1e-4), the
same assignments and iteration counts, and inertia within rtol 1e-4. The
seeded stages (k-means++, restarts, subsamples) draw from torch
generators, which never reproduce JAX's threefry draws, so they are held
to statistical bounds written in each test.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import kmeans as km

from conftest import planted_gmm_data

# repro.core re-exports the function kmeans under the module's name
jkm = importlib.import_module("repro.core.kmeans")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    x, y, mus = planted_gmm_data(rng, n=900, d=3, k=4, spread=6.0, std=0.5,
                                 min_sep_sigma=8.0)
    w = np.ones(len(x), np.float32)
    w[-100:] = 0.0  # padded rows
    return x, y, w


@pytest.mark.parametrize("backend,chunk", [("reference", None),
                                           ("fused", None),
                                           ("reference", 128)])
def test_kmeans_from_injected_centers_matches_jax(data, backend, chunk):
    x, _, w = data
    init = x[[0, 5, 10, 15]].copy()
    exp = jkm.kmeans(jax.random.key(0), jnp.asarray(x), 4, jnp.asarray(w),
                     max_iter=50, chunk_size=chunk,
                     init_centers=jnp.asarray(init))
    got = km.kmeans(0, torch.as_tensor(x), 4, torch.as_tensor(w),
                    max_iter=50, chunk_size=chunk, assign_backend=backend,
                    init_centers=torch.as_tensor(init))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(exp.centers),
                               atol=1e-4)
    np.testing.assert_array_equal(got.assignments.numpy(),
                                  np.asarray(exp.assignments))
    np.testing.assert_allclose(float(got.inertia), float(exp.inertia),
                               rtol=1e-4)
    np.testing.assert_allclose(got.cluster_sizes.numpy(),
                               np.asarray(exp.cluster_sizes), atol=1e-3)
    assert int(got.n_iter) == int(exp.n_iter)


def test_batched_members_stop_on_their_own(data):
    """A batch of problems equals the problems one by one, each with its
    own iteration count and its centers frozen once its own shift drops
    to tol (the vmapped while_loop's freeze). With tol = 0.5 a member stops
    while its centers still move by ~0.1, so a member that kept iterating
    would show; the bound is atol 1e-5."""
    x, _, w = data
    starts = [x[[0, 5, 10, 15]], x[[1, 2, 3, 4]], x[[0, 1, 2, 3]] * 3]
    xs = torch.as_tensor(np.stack([x, x, x]))
    ws = torch.as_tensor(np.stack([w, w, np.ones_like(w)]))
    batch = km.kmeans(0, xs, 4, ws, max_iter=50, tol=0.5,
                      init_centers=torch.as_tensor(np.stack(starts)))
    for i in range(3):
        one = km.kmeans(0, xs[i], 4, ws[i], max_iter=50, tol=0.5,
                        init_centers=torch.as_tensor(starts[i]))
        assert int(batch.n_iter[i]) == int(one.n_iter)
        np.testing.assert_allclose(batch.centers[i].numpy(),
                                   one.centers.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(batch.assignments[i].numpy(),
                                      one.assignments.numpy())


def _hits(centers, mus, radius):
    """Number of planted clusters that received a seed within ``radius``."""
    d = np.linalg.norm(centers[:, None, :] - mus[None], axis=-1)
    return len(set(np.flatnonzero(d.min(0) < radius)))


def test_kmeanspp_seeding_statistics():
    """On 4 clusters 8 sigma apart, k-means++ puts one seed in every
    cluster with high probability. Over 30 seeds, both packages must cover
    all clusters at least 80% of the time, and the port's rate may trail
    JAX's by at most 0.2. Zero-weight rows are never drawn."""
    rng = np.random.default_rng(8)
    x, _, mus = planted_gmm_data(rng, n=800, d=3, k=4, spread=6.0, std=0.5,
                                 min_sep_sigma=8.0)
    w = np.ones(len(x), np.float32)
    w[::7] = 0.0
    x[::7] = 1e3  # padded rows sit far away: a drawn one would show
    jpp = jax.jit(jkm.kmeans_plusplus, static_argnums=2)
    port = jaxr = 0
    for s in range(30):
        c = km.kmeans_plusplus(s, torch.as_tensor(x), 4,
                               torch.as_tensor(w)).numpy()
        assert np.all(np.abs(c) < 1e2)
        port += _hits(c, mus, 2.0) == 4
        jc = np.asarray(jpp(jax.random.key(s),
                            jnp.asarray(x), 4,
                            jnp.asarray(w)))
        jaxr += _hits(jc, mus, 2.0) == 4
    assert port / 30 >= 0.8 and jaxr / 30 >= 0.8
    assert port / 30 >= jaxr / 30 - 0.2


@pytest.mark.parametrize("seed_rows", [16384, 300])
def test_kmeans_multi_reaches_reference_inertia(data, seed_rows):
    """Best-of-4 restarts (with the subsample branch when N > seed_rows)
    find the planted optimum: inertia within 1% of the JAX package's, and
    every planted cluster recovered."""
    x, y, w = data
    exp = jkm.kmeans_multi(jax.random.key(0), jnp.asarray(x), 4,
                           jnp.asarray(w), max_iter=50, seed_rows=seed_rows)
    for seed in range(3):
        got = km.kmeans_multi(seed, torch.as_tensor(x), 4,
                              torch.as_tensor(w), max_iter=50,
                              seed_rows=seed_rows)
        np.testing.assert_allclose(float(got.inertia), float(exp.inertia),
                                   rtol=1e-2)
        assign = got.assignments.numpy()[w > 0]
        labels = y[w > 0]
        # a clean recovery maps every planted class to one cluster
        for c in range(4):
            assert len(set(assign[labels == c])) == 1
