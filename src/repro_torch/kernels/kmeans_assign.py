"""Launch wrappers of the CUDA k-means kernels (``csrc/kmeans_assign.cu``),
the port of the Pallas kernel in ``repro/kernels/kmeans_assign.py`` and of
the one-hot reductions of ``repro/core/kmeans.py::_sweep_block``.

``kmeans_assign(x, ct, c2)`` takes a batch of problems with their packed
operands (transposed centers and squared center norms) and returns the
nearest center of each row and its squared distance.
``kmeans_sweep_stats(x, w, ct, c2)`` runs the same assignment and returns
the weighted Lloyd-sweep statistics (counts, sums, inertia) without
materializing the one-hot matrix. On CPU tensors both run their plain
versions (``ref.kmeans_assign_packed``, ``ref.kmeans_sweep_packed``); on
CUDA tensors they launch the kernel or raise. ``launches`` and
``sweep_launches`` count the launches of each.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches = 0
sweep_launches = 0

_ASSIGN_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_SWEEP_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

_plans: dict = {}


def chunk_plan(problems: int, tiles: int, slots: int) -> tuple[int, int]:
    """(tiles per chunk, chunks per problem): the fewest tiles per chunk
    with which ``problems`` x chunks blocks, each walking one chunk of
    consecutive row tiles, fit in the ``slots`` blocks the card holds at
    once. Every chunk has a tile."""
    per_chunk = max(1, -(-(problems * tiles) // max(slots, 1)))
    return per_chunk, -(-tiles // per_chunk)


def _plan(x: torch.Tensor, k: int, stats: bool) -> tuple[int, int]:
    """(tiles per chunk, chunks per problem) for one launch: the kernel's
    tile rows and blocks per SM come from its library (``kmeans_plan``,
    cached per device and shape), the chunks from :func:`chunk_plan`."""
    bsz, n, d = x.shape
    if k < 1:
        raise ValueError("the k-means kernels need at least one center")
    key = (x.device.index, d, k, stats)
    if key not in _plans:
        fn = _build.function("kmeans_assign", "kmeans_plan",
                             [ctypes.c_int] * 3
                             + [ctypes.POINTER(ctypes.c_int)] * 2)
        rows, per_sm = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(x.device):
            _build.check_launch("kmeans_assign", fn(
                d, k, int(stats), ctypes.byref(rows), ctypes.byref(per_sm)))
        if per_sm.value < 1:
            raise RuntimeError(f"kmeans kernels: no block fits on an SM at "
                               f"d={d}, K={k}")
        sms = torch.cuda.get_device_properties(
            x.device).multi_processor_count
        _plans[key] = (rows.value, sms * per_sm.value)
    rows, slots = _plans[key]
    return chunk_plan(bsz, -(-n // rows), slots)


def kmeans_assign(x: torch.Tensor, ct: torch.Tensor, c2: torch.Tensor):
    """x (B, N, d), ct (B, d, K), c2 (B, K) float32 ->
    (idx (B, N) int32, d2min (B, N) float32)."""
    global launches
    if x.device.type == "cpu":
        return ref.kmeans_assign_packed(x, ct, c2)
    bsz, n, d = x.shape
    k = ct.shape[-1]
    dev = x.device
    _build.require(x, "x", (bsz, n, d), dev)
    _build.require(ct, "ct", (bsz, d, k), dev)
    _build.require(c2, "c2", (bsz, k), dev)
    idx = torch.empty((bsz, n), dtype=torch.int32, device=dev)
    dmin = torch.empty((bsz, n), dtype=torch.float32, device=dev)
    per_chunk, _ = _plan(x, k, False)
    if n == 0 or bsz == 0:
        return idx, dmin
    fn = _build.function("kmeans_assign", "kmeans_assign_launch", _ASSIGN_ARGS)
    with torch.cuda.device(dev):
        code = fn(x.data_ptr(), ct.data_ptr(), c2.data_ptr(), idx.data_ptr(),
                  dmin.data_ptr(), bsz, n, d, k, per_chunk,
                  _build.stream_of(x))
    _build.check_launch("kmeans_assign", code)
    with _build.COUNT_LOCK:
        launches += 1
    return idx, dmin


def kmeans_sweep_stats(x: torch.Tensor, w: torch.Tensor, ct: torch.Tensor,
                       c2: torch.Tensor, with_idx: bool = False):
    """x (B, N, d), w (B, N), ct (B, d, K), c2 (B, K) float32 ->
    (counts (B, K), sums (B, K, d), inertia (B,), idx (B, N) int32 or None):
    the weighted statistics of one Lloyd sweep against the nearest-center
    assignment; ``idx`` only when ``with_idx``."""
    global sweep_launches
    if x.device.type == "cpu":
        counts, sums, inertia, idx = ref.kmeans_sweep_packed(x, w, ct, c2)
        return counts, sums, inertia, idx if with_idx else None
    bsz, n, d = x.shape
    k = ct.shape[-1]
    dev = x.device
    _build.require(x, "x", (bsz, n, d), dev)
    _build.require(w, "w", (bsz, n), dev)
    _build.require(ct, "ct", (bsz, d, k), dev)
    _build.require(c2, "c2", (bsz, k), dev)
    per_chunk, chunks = _plan(x, k, True)
    p_len = k + k * d + 1
    out = torch.empty((bsz, p_len), dtype=torch.float32, device=dev)
    idx: Optional[torch.Tensor] = (
        torch.empty((bsz, n), dtype=torch.int32, device=dev) if with_idx
        else None)
    if n == 0 or bsz == 0:
        out.zero_()
    else:
        partial = torch.empty((bsz, chunks, p_len), dtype=torch.float32,
                              device=dev)
        fn = _build.function("kmeans_assign", "kmeans_sweep_launch",
                             _SWEEP_ARGS)
        with torch.cuda.device(dev):
            code = fn(x.data_ptr(), w.data_ptr(), ct.data_ptr(),
                      c2.data_ptr(), None if idx is None else idx.data_ptr(),
                      partial.data_ptr(), out.data_ptr(), bsz, n, d, k,
                      per_chunk, _build.stream_of(x))
        _build.check_launch("kmeans_assign", code)
        with _build.COUNT_LOCK:
            sweep_launches += 1
    return (out[:, :k], out[:, k:k + k * d].view(bsz, k, d), out[:, -1],
            idx)
