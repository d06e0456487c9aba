"""Launch wrapper of the CUDA ``kmeans_assign`` kernel
(``csrc/kmeans_assign.cu``), the port of the Pallas kernel in
``repro/kernels/kmeans_assign.py``.

``kmeans_assign(x, ct, c2)`` takes a batch of problems with their packed
operands (transposed centers and squared center norms). On CPU tensors it
runs the plain version, ``ref.kmeans_assign_packed``; on CUDA tensors it
launches the kernel or raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


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
    if k == 0:
        raise ValueError("kmeans_assign needs at least one center")
    idx = torch.empty((bsz, n), dtype=torch.int32, device=dev)
    dmin = torch.empty((bsz, n), dtype=torch.float32, device=dev)
    if n == 0 or bsz == 0:
        return idx, dmin
    fn = _build.function("kmeans_assign", "kmeans_assign_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(x.data_ptr(), ct.data_ptr(), c2.data_ptr(), idx.data_ptr(),
                  dmin.data_ptr(), bsz, n, d, k, _build.stream_of(x))
    _build.check_launch("kmeans_assign", code)
    launches += 1
    return idx, dmin
