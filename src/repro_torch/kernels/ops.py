"""Model-level entry points of the kernels (port of
``repro/kernels/ops.py``).

They pack model parameters into the matmul-identity operands
(:func:`pack_params`: A = -1/2 var^-1 and B = mu / var as (d, K), and
c_k = -1/2 (sum mu^2/var + sum log var + d log 2pi) + log w_k) and hand them
to the launch wrappers, which run the CUDA kernel on CUDA tensors and the
plain version on CPU tensors. The kernels take ragged N, d and K as they
are, so nothing is padded: the TPU's 128-lane padding has no counterpart.
Which implementation runs is chosen by the tensors' device and by the
engine's backend resolution (``repro_torch.core.config``), never by a flag
here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.estep_stats import estep_stats as _estep_kernel
from repro_torch.kernels.gmm_logpdf import gmm_log_prob as _log_prob_kernel
from repro_torch.kernels.gmm_logpdf import gmm_logpdf as _logpdf_kernel
from repro_torch.kernels.kmeans_assign import kmeans_assign as _assign_kernel
from repro_torch.kernels.kmeans_assign import (
    kmeans_sweep_stats as _sweep_kernel)

LOG_2PI = 1.8378770664093453


def pack_params(means: torch.Tensor, variances: torch.Tensor,
                log_weights: Optional[torch.Tensor] = None):
    """(means, variances[, log_weights]) with shapes (..., K, d) ->
    (a (..., d, K), b (..., d, K), c (..., K)), float32 and contiguous."""
    means = means.to(torch.float32)
    variances = variances.to(torch.float32)
    d = means.shape[-1]
    inv_var = 1.0 / variances
    a = (-0.5 * inv_var).transpose(-1, -2).contiguous()
    b = (means * inv_var).transpose(-1, -2).contiguous()
    c = -0.5 * (torch.sum(means * means * inv_var, dim=-1)
                + torch.sum(torch.log(variances), dim=-1) + d * LOG_2PI)
    if log_weights is not None:
        c = c + log_weights.to(torch.float32)
    return a, b, c.contiguous()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def gmm_logpdf(x: torch.Tensor, means: torch.Tensor, variances: torch.Tensor,
               log_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Diagonal-GMM per-component log density, (N, d) -> (N, K) float32."""
    a, b, c = pack_params(means, variances, log_weights)
    return _logpdf_kernel(_f32(x), a, b, c)


def gmm_log_prob(x: torch.Tensor, means: torch.Tensor,
                 variances: torch.Tensor,
                 log_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Diagonal-GMM mixture log density of each row, (N, d) -> (N,)
    float32: the logsumexp of :func:`gmm_logpdf` over components, with the
    (N, K) matrix never written."""
    a, b, c = pack_params(means, variances, log_weights)
    return _log_prob_kernel(_f32(x), a, b, c)


def estep_stats(x: torch.Tensor, means: torch.Tensor, variances: torch.Tensor,
                log_weights: torch.Tensor,
                sample_weight: Optional[torch.Tensor] = None):
    """Fused E-step statistics. x (N, d) with one model (K, d), or a batch
    x (C, N, d) with one model per client (C, K, d). Returns (s0 (.., K),
    s1 (.., K, d), s2 (.., K, d), ll (..)), float32."""
    single = x.ndim == 2
    if single:
        x, means, variances, log_weights = (
            x[None], means[None], variances[None], log_weights[None])
        if sample_weight is not None:
            sample_weight = sample_weight[None]
    w = (torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
         if sample_weight is None else sample_weight)
    a, b, c = pack_params(means, variances, log_weights)
    s0, s1, s2, ll = _estep_kernel(_f32(x), _f32(w), a, b, c)
    if single:
        return s0[0], s1[0], s2[0], ll[0]
    return s0, s1, s2, ll


def _pack_centers(centers: torch.Tensor):
    """centers (B, K, d) -> (transposed centers (B, d, K), |c|^2 (B, K))."""
    centers = centers.to(torch.float32)
    return (centers.transpose(-1, -2).contiguous(),
            torch.sum(centers * centers, dim=-1).contiguous())


def kmeans_assign(x: torch.Tensor, centers: torch.Tensor):
    """Nearest-center assignment. x (N, d) with centers (K, d), or a batch
    x (B, N, d) with centers (B, K, d). Returns (int32 index, squared
    distance), each (N,) or (B, N)."""
    single = x.ndim == 2
    if single:
        x, centers = x[None], centers[None]
    idx, d2 = _assign_kernel(_f32(x), *_pack_centers(centers))
    if single:
        return idx[0], d2[0]
    return idx, d2


def kmeans_sweep(x: torch.Tensor, w: torch.Tensor, centers: torch.Tensor,
                 with_idx: bool = False):
    """Weighted Lloyd-sweep statistics of the nearest-center assignment of
    a batch x (B, N, d), weights (B, N), centers (B, K, d): (counts (B, K),
    sums (B, K, d), inertia (B,), int32 labels (B, N) or None), the labels
    only when ``with_idx``."""
    return _sweep_kernel(_f32(x), _f32(w), *_pack_centers(centers),
                         with_idx=with_idx)
