"""Launch wrapper of the CUDA ``estep_stats`` kernel
(``csrc/estep_stats.cu``), the port of the Pallas kernel in
``repro/kernels/estep_stats.py``.

``estep_stats(x, w, a, b, c)`` takes a batch of clients with their packed
matmul-identity operands. On CPU tensors it runs the plain version,
``ref.estep_stats_packed``; on CUDA tensors it launches the kernel (two
passes: per-(client, 256-row chunk) partials, then a fixed-order sum) or
raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

# csrc/estep_stats.cu: rows a partial sums, the largest K
CHUNK_ROWS = 256
MAX_K = 512


def estep_stats(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor):
    """x (C, N, d), w (C, N), a/b (C, d, K), c (C, K) float32 ->
    (s0 (C, K), s1 (C, K, d), s2 (C, K, d), ll (C,))."""
    global launches
    if x.device.type == "cpu":
        return ref.estep_stats_packed(x, w, a, b, c)
    cl, n, d = x.shape
    k = a.shape[-1]
    dev = x.device
    _build.require(x, "x", (cl, n, d), dev)
    _build.require(w, "w", (cl, n), dev)
    _build.require(a, "a", (cl, d, k), dev)
    _build.require(b, "b", (cl, d, k), dev)
    _build.require(c, "c", (cl, k), dev)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"estep_stats takes 1 <= K <= {MAX_K}, got {k}")
    p_len = k + 2 * k * d + 1
    out = torch.empty((cl, p_len), dtype=torch.float32, device=dev)
    if n == 0 or cl == 0:
        out.zero_()
    else:
        partial = torch.empty((cl, -(-n // CHUNK_ROWS), p_len),
                              dtype=torch.float32, device=dev)
        fn = _build.function("estep_stats", "estep_stats_launch", _ARGTYPES)
        with torch.cuda.device(dev):
            code = fn(x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
                      c.data_ptr(), partial.data_ptr(), out.data_ptr(),
                      cl, n, d, k, _build.stream_of(x))
        _build.check_launch("estep_stats", code)
        with _build.COUNT_LOCK:
            launches += 1
    kd = k * d
    return (out[:, :k], out[:, k:k + kd].view(cl, k, d),
            out[:, k + kd:k + 2 * kd].view(cl, k, d), out[:, -1])
