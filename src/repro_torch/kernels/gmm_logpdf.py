"""Launch wrapper of the CUDA ``gmm_logpdf`` kernel (``csrc/gmm_logpdf.cu``),
the port of the Pallas kernel in ``repro/kernels/gmm_logpdf.py``.

``gmm_logpdf(x, a, b, c)`` takes the packed matmul-identity operands
(``repro_torch.kernels.ops`` packs them). On CPU tensors it runs the plain
version, ``ref.gmm_logpdf_packed``; on CUDA tensors it launches the kernel or
raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def gmm_logpdf(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """x (N, d), a/b (d, K), c (K,) float32 -> (N, K) = (x*x)@a + x@b + c."""
    global launches
    if x.device.type == "cpu":
        return ref.gmm_logpdf_packed(x, a, b, c)
    n, d = x.shape
    k = a.shape[1]
    dev = x.device
    _build.require(x, "x", (n, d), dev)
    _build.require(a, "a", (d, k), dev)
    _build.require(b, "b", (d, k), dev)
    _build.require(c, "c", (k,), dev)
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    if n == 0 or k == 0:
        return out
    fn = _build.function("gmm_logpdf", "gmm_logpdf_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        code = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                  out.data_ptr(), n, d, k, _build.stream_of(x))
    _build.check_launch("gmm_logpdf", code)
    launches += 1
    return out
