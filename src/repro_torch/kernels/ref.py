"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``,
plus the k-means sweep statistics of ``repro/core/kmeans.py``).

Two forms of each function live here:

* the oracles (``*_ref``) take model parameters (means, variances, log
  weights, centers), exactly as ``repro.kernels.ref`` does;
* the packed forms (``*_packed``) take the matmul-identity operands the
  CUDA kernels take (A = -1/2 var^-1, B = mu / var, c; or the transposed
  centers and their squared norms). They compute each kernel's function
  from the same operands: the launch wrappers run them on CPU tensors, and
  ``chip_smoke.py`` holds each kernel against them on the card.

Every function accepts optional leading batch dimensions.
"""
from __future__ import annotations

from typing import Optional

import torch

LOG_2PI = 1.8378770664093453


def gmm_logpdf_ref(x: torch.Tensor, means: torch.Tensor,
                   variances: torch.Tensor,
                   log_weights: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Per-component diagonal-Gaussian log density. (N,d),(K,d),(K,d)->(N,K).

    If log_weights is given, returns log(w_k N(x|...)) (the E-step numerator).
    """
    d = x.shape[-1]
    inv_var = 1.0 / variances
    a = (x * x) @ inv_var.transpose(-1, -2)
    b = x @ (means * inv_var).transpose(-1, -2)
    c = torch.sum(means * means * inv_var + torch.log(variances), dim=-1)
    out = -0.5 * (a - 2.0 * b + c.unsqueeze(-2) + d * LOG_2PI)
    if log_weights is not None:
        out = out + log_weights.unsqueeze(-2)
    return out


def estep_stats_ref(x: torch.Tensor, means: torch.Tensor,
                    variances: torch.Tensor, log_weights: torch.Tensor,
                    sample_weight: Optional[torch.Tensor] = None):
    """Fused E-step sufficient statistics (diagonal covariance).

    Returns (s0 (K,), s1 (K,d), s2 (K,d), loglik ()).
    """
    w = (torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
         if sample_weight is None else sample_weight)
    lp = gmm_logpdf_ref(x, means, variances, log_weights)       # (N, K)
    log_norm = torch.logsumexp(lp, dim=-1)                       # (N,)
    resp = torch.exp(lp - log_norm.unsqueeze(-1)) * w.unsqueeze(-1)
    rt = resp.transpose(-1, -2)
    return (resp.sum(dim=-2), rt @ x, rt @ (x * x),
            torch.sum(log_norm * w, dim=-1))


def kmeans_assign_ref(x: torch.Tensor, centers: torch.Tensor):
    """Squared distances + argmin assignment. (N,d),(K,d) -> ((N,), (N,))."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=-1).unsqueeze(-2)
    d2 = torch.clamp(x2 - 2.0 * (x @ centers.transpose(-1, -2)) + c2,
                     min=0.0)
    return torch.argmin(d2, dim=-1), d2.min(dim=-1).values


# ----------------------------------------------------------------------
# Packed forms: the kernels' own operands and arithmetic
# ----------------------------------------------------------------------

def gmm_logpdf_packed(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor) -> torch.Tensor:
    """x (N, d), a/b (d, K), c (K,) -> (x*x)@a + x@b + c, (N, K)."""
    return (x * x) @ a + x @ b + c.unsqueeze(-2)


def gmm_log_prob_packed(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor) -> torch.Tensor:
    """x (N, d), a/b (d, K), c (K,) -> the mixture log density of each row,
    logsumexp of ``gmm_logpdf_packed`` over components, (N,)."""
    return torch.logsumexp(gmm_logpdf_packed(x, a, b, c), dim=-1)


def estep_stats_packed(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor):
    """x (C, N, d), w (C, N), a/b (C, d, K), c (C, K) ->
    (s0 (C, K), s1 (C, K, d), s2 (C, K, d), ll (C,)): the row-softmax
    responsibilities of ``gmm_logpdf_packed`` reduced against x and x*x."""
    xx = x * x
    lp = xx @ a + x @ b + c.unsqueeze(-2)
    m = lp.max(dim=-1, keepdim=True).values
    p = torch.exp(lp - m)
    denom = p.sum(dim=-1, keepdim=True)
    log_norm = (m + torch.log(denom)).squeeze(-1)
    resp = (p / denom) * w.unsqueeze(-1)
    rt = resp.transpose(-1, -2)
    return resp.sum(dim=-2), rt @ x, rt @ xx, torch.sum(log_norm * w, dim=-1)


def kmeans_assign_packed(x: torch.Tensor, ct: torch.Tensor,
                         c2: torch.Tensor):
    """x (B, N, d), ct (B, d, K), c2 (B, K) -> (idx (B, N) int32,
    d2min (B, N)), d2 = max(|x|^2 - 2 x.c + |c|^2, 0), ties to the first
    index."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    d2 = torch.clamp(x2 - 2.0 * (x @ ct) + c2.unsqueeze(-2), min=0.0)
    return (torch.argmin(d2, dim=-1).to(torch.int32),
            d2.min(dim=-1).values)


def kmeans_sweep_packed(x: torch.Tensor, w: torch.Tensor, ct: torch.Tensor,
                        c2: torch.Tensor):
    """x (B, N, d), w (B, N), ct (B, d, K), c2 (B, K) -> (counts (B, K),
    sums (B, K, d), inertia (B,), idx (B, N) int32): the weighted Lloyd-sweep
    statistics of ``kmeans_assign_packed``'s assignment, in the one-hot
    formulation of ``repro/core/kmeans.py::_sweep_block``."""
    idx, d2 = kmeans_assign_packed(x, ct, c2)
    cols = torch.arange(ct.shape[-1], device=x.device)
    oh = (idx.unsqueeze(-1) == cols).to(x.dtype) * w.unsqueeze(-1)
    return (oh.sum(dim=-2), oh.transpose(-1, -2) @ x,
            torch.sum(d2 * w, dim=-1), idx)
