"""The fused Lloyd sweep of ``repro_torch.core.kmeans`` against
``repro.core.kmeans._sweep_block`` (CPU), and the build helpers of the
sweep's kernel.

On CPU tensors the ``fused`` backend's ``_sweep_block``/``_update_block``
run ``ref.kmeans_sweep_packed`` through the same packing
(``ops.kmeans_sweep``) that feeds the CUDA ``kmeans_sweep_stats`` kernel on
the card. They must give the JAX function's counts, sums and inertia within
rtol/atol 2e-4 (the kernel tolerance of tests/test_kernels.py) on the same
numpy data and centers, with duplicated centers (ties go to the first
index), an empty cluster and zero-weight rows among the cases.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import kmeans as km
from repro_torch.kernels import _build, kmeans_assign, ops, ref

# repro.core re-exports the function kmeans under the module's name
jkm = importlib.import_module("repro.core.kmeans")

jax_sweep = jax.jit(jkm._sweep_block, static_argnums=3)


def sweep_inputs(seed, n, d, k, ties=False, empty=False):
    """Rows, weights (every 5th and the last tenth zero) and centers; with
    ``empty`` center 0 sits far from every row, with ``ties`` the last two
    centers duplicate centers 1 and 2."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (n, d)).astype(np.float32)
    w = rng.uniform(0, 1, n).astype(np.float32)
    w[::5] = 0.0
    w[n - n // 10:] = 0.0
    c = rng.normal(0, 2, (k, d)).astype(np.float32)
    if empty:
        c[0] = 1e3
    if ties:
        c[k - 2:] = c[1:3]
    return x, w, c


CASES = [  # (n, d, k, ties, empty)
    (300, 24, 30, False, False),
    (257, 24, 30, True, True),
    (513, 11, 7, True, False),
    (100, 3, 5, False, True),
    (64, 128, 64, True, True),
    (17, 4, 1, False, False),
]


def jax_stats(x, w, c):
    counts, sums, inertia = jax_sweep(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(c), "reference")
    return np.asarray(counts), np.asarray(sums), float(inertia)


@pytest.mark.parametrize("n,d,k,ties,empty", CASES)
def test_fused_sweep_block_matches_jax(n, d, k, ties, empty):
    x, w, c = sweep_inputs(n + d + k, n, d, k, ties, empty)
    ecounts, esums, einertia = jax_stats(x, w, c)
    counts, sums, inertia = km._sweep_block(
        torch.as_tensor(x)[None], torch.as_tensor(w)[None],
        torch.as_tensor(c)[None], "fused")
    np.testing.assert_allclose(counts[0].numpy(), ecounts, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(sums[0].numpy(), esums, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(inertia[0]), einertia, rtol=2e-4,
                               atol=2e-4)
    if empty:
        assert float(counts[0, 0]) == 0.0
    if ties:  # the duplicates never win a row: ties go to the first index
        assert np.all(counts[0, k - 2:].numpy() == 0.0)


@pytest.mark.parametrize("n,d,k,ties,empty", CASES)
def test_fused_update_block_matches_jax(n, d, k, ties, empty):
    """``_update_block`` is the Lloyd loop's counts and sums (the JAX
    package computes them inside ``_lloyd`` with ``_sweep_block``)."""
    x, w, c = sweep_inputs(2 * n + d, n, d, k, ties, empty)
    ecounts, esums, _ = jax_stats(x, w, c)
    counts, sums = km._update_block(
        torch.as_tensor(x)[None], torch.as_tensor(w)[None],
        torch.as_tensor(c)[None], "fused")
    np.testing.assert_allclose(counts[0].numpy(), ecounts, rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(sums[0].numpy(), esums, rtol=2e-4, atol=2e-4)


def test_batched_sweep_is_per_problem():
    """The leading batch axis of the sweep equals one JAX call per problem
    (clients x restarts run as one batch on the card)."""
    probs = [sweep_inputs(40 + i, 200, 6, 5, ties=i == 1, empty=i == 2)
             for i in range(3)]
    xs, ws, cs = (torch.as_tensor(np.stack(a)) for a in zip(*probs))
    counts, sums, inertia = km._sweep_block(xs, ws, cs, "fused")
    for i, (x, w, c) in enumerate(probs):
        ecounts, esums, einertia = jax_stats(x, w, c)
        np.testing.assert_allclose(counts[i].numpy(), ecounts, rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(sums[i].numpy(), esums, rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(float(inertia[i]), einertia, rtol=2e-4,
                                   atol=2e-4)


def test_sweep_labels_and_reference_backend_agree():
    """``ops.kmeans_sweep`` returns the assignment it reduced (the labels of
    ``ops.kmeans_assign``) only when asked, and the fused and reference
    backends of ``_sweep_block`` agree on CPU tensors."""
    x, w, c = (torch.as_tensor(a) for a in sweep_inputs(3, 400, 9, 6, True))
    counts, sums, inertia, idx = ops.kmeans_sweep(x[None], w[None], c[None],
                                                  with_idx=True)
    eidx, _ = ops.kmeans_assign(x, c)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx[0].numpy(), eidx.numpy())
    assert ops.kmeans_sweep(x[None], w[None], c[None])[3] is None
    rcounts, rsums, rinertia = km._sweep_block(x[None], w[None], c[None],
                                               "reference")
    for got, exp in ((counts, rcounts), (sums, rsums), (inertia, rinertia)):
        np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_plain_sweep_is_the_onehot_formula():
    """``ref.kmeans_sweep_packed`` on packed operands equals the one-hot
    sums of JAX's weighted one-hot matrix (``_labels_onehot``)."""
    x, w, c = sweep_inputs(11, 300, 24, 30, ties=True)
    ct = torch.as_tensor(c.T.copy())[None]
    c2 = torch.as_tensor((c * c).sum(1))[None]
    counts, sums, inertia, idx = ref.kmeans_sweep_packed(
        torch.as_tensor(x)[None], torch.as_tensor(w)[None], ct, c2)
    oh = np.asarray(jkm._labels_onehot(jnp.asarray(idx[0].numpy()), 30,
                                       jnp.asarray(w), jnp.float32))
    np.testing.assert_allclose(counts[0].numpy(), oh.sum(0), rtol=1e-6)
    np.testing.assert_allclose(sums[0].numpy(), oh.T @ x, rtol=2e-4,
                               atol=2e-4)
    assert kmeans_assign.kmeans_sweep_stats(
        torch.as_tensor(x)[None], torch.as_tensor(w)[None], ct, c2)[3] is None


# ----------------------------------------------------------------------
# Build helpers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name,headers", [
    ("estep_stats", ["tile_reduce.cuh"]),
    ("kmeans_assign", ["tile_reduce.cuh"]),
    ("gmm_logpdf", ["tile_reduce.cuh"]),
])
def test_sources_of_lists_included_headers(name, headers):
    got = [p.name for p in _build.sources_of(name)]
    assert got == [f"{name}.cu"] + headers


def test_library_path_follows_an_included_header(tmp_path, monkeypatch):
    """Editing a header that a source includes renames (so rebuilds) the
    source's library; a header it does not include leaves it as it is."""
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    unused = tmp_path / "unused.cuh"
    unused.write_bytes(b"#pragma once\n")
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    unused.write_bytes(b"#pragma once\n// edited\n")
    assert {n: _build.library_path(n) for n in _build.SOURCES} == before
    hdr = tmp_path / "tile_reduce.cuh"
    hdr.write_bytes(hdr.read_bytes() + b"\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert after["estep_stats"] != before["estep_stats"]
    assert after["kmeans_assign"] != before["kmeans_assign"]
    assert after["gmm_logpdf"] != before["gmm_logpdf"]


@pytest.mark.parametrize("problems,tiles,slots", [
    (20, 115, 396), (1, 469, 396), (80, 29, 528), (1, 1, 132),
    (4, 64, 264), (3, 10, 1000), (20, 29, 7)])
def test_chunk_plan_covers_every_tile_once(problems, tiles, slots):
    """Every chunk has a tile, the chunks cover the tiles, and the grid
    fits in the card's slots unless one tile a chunk is already too many."""
    per_chunk, chunks = kmeans_assign.chunk_plan(problems, tiles, slots)
    assert per_chunk >= 1
    assert (chunks - 1) * per_chunk < tiles <= chunks * per_chunk
    assert problems * chunks <= max(slots, problems) + problems
    if per_chunk > 1:  # one tile fewer a chunk would overfill the card
        assert problems * -(-tiles // (per_chunk - 1)) > slots

