"""Launch wrappers of the CUDA log-density kernels (``csrc/gmm_logpdf.cu``),
the port of the Pallas kernel in ``repro/kernels/gmm_logpdf.py`` and of the
row logsumexp its scoring caller runs after it.

Both take the packed matmul-identity operands (``repro_torch.kernels.ops``
packs them). ``gmm_logpdf(x, a, b, c)`` returns the per-component log
densities (N, K); ``gmm_log_prob(x, a, b, c)`` returns each row's mixture
log density (N,) without writing the (N, K) matrix. On CPU tensors they run
their plain versions (``ref.gmm_logpdf_packed``, ``ref.gmm_log_prob_packed``);
on CUDA tensors they launch the kernel or raise. ``launches`` and
``log_prob_launches`` count the launches of each.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

launches = 0
log_prob_launches = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _require(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> tuple[int, int, int]:
    n, d = x.shape
    k = a.shape[1]
    _build.require(x, "x", (n, d), x.device)
    _build.require(a, "a", (d, k), x.device)
    _build.require(b, "b", (d, k), x.device)
    _build.require(c, "c", (k,), x.device)
    return n, d, k


def _launch(symbol: str, x, a, b, c, out, n: int, d: int, k: int) -> None:
    fn = _build.function("gmm_logpdf", symbol, _ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                  out.data_ptr(), n, d, k, _build.stream_of(x))
    _build.check_launch("gmm_logpdf", code)


def gmm_logpdf(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """x (N, d), a/b (d, K), c (K,) float32 -> (N, K) = (x*x)@a + x@b + c."""
    global launches
    if x.device.type == "cpu":
        return ref.gmm_logpdf_packed(x, a, b, c)
    n, d, k = _require(x, a, b, c)
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    if n == 0 or k == 0:
        return out
    _launch("gmm_logpdf_launch", x, a, b, c, out, n, d, k)
    with _build.COUNT_LOCK:
        launches += 1
    return out


def gmm_log_prob(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """x (N, d), a/b (d, K), c (K,) float32 -> (N,) =
    logsumexp((x*x)@a + x@b + c, -1)."""
    global log_prob_launches
    if x.device.type == "cpu":
        return ref.gmm_log_prob_packed(x, a, b, c)
    n, d, k = _require(x, a, b, c)
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0 or k == 0:
        return out.fill_(-float("inf"))
    _launch("gmm_log_prob_launch", x, a, b, c, out, n, d, k)
    with _build.COUNT_LOCK:
        log_prob_launches += 1
    return out
