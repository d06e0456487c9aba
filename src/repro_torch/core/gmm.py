"""Gaussian Mixture Model primitives (port of ``repro/core/gmm.py``).

A GMM is a frozen dataclass of tensors (weights, means, covs):
  weights : (K,)        mixing weights, sum to 1
  means   : (K, d)
  covs    : (K, d)      diagonal covariance (variances), or
            (K, d, d)   full covariance

The engine (``repro_torch.core.em``) also carries *stacked* models, one per
client, with a leading batch axis on every leaf: weights (B, K), means
(B, K, d), covs (B, K, d) or (B, K, d, d). ``is_diagonal`` reads the leaf
ranks, so it holds for both forms.

The log-density functions here take any leading batch shape and use the
matmul identity ``x²@A + x@B + c`` for diagonal covariance, which is what
the ``gmm_logpdf`` kernel computes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

LOG_2PI = 1.8378770664093453


@dataclasses.dataclass(frozen=True)
class GMM:
    """Gaussian mixture parameters."""

    weights: torch.Tensor  # (K,) or (B, K)
    means: torch.Tensor    # (K, d) or (B, K, d)
    covs: torch.Tensor     # diag (.., K, d) or full (.., K, d, d)

    @property
    def n_components(self) -> int:
        return self.weights.shape[-1]

    @property
    def n_features(self) -> int:
        return self.means.shape[-1]

    @property
    def is_diagonal(self) -> bool:
        return self.covs.ndim == self.means.ndim

    @property
    def device(self) -> torch.device:
        return self.means.device

    def to(self, device) -> "GMM":
        return GMM(self.weights.to(device), self.means.to(device),
                   self.covs.to(device))

    def __getitem__(self, i) -> "GMM":
        """Member ``i`` of a stacked model."""
        return GMM(self.weights[i], self.means[i], self.covs[i])

    # ------------------------------------------------------------------
    def component_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """Per-component Gaussian log density. x: (N, d) -> (N, K)."""
        if self.is_diagonal:
            return _diag_component_log_prob(x, self.means, self.covs)
        return _full_component_log_prob(x, self.means, self.covs)

    def _weighted_log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return (self.component_log_prob(x)
                + torch.log(self.weights).unsqueeze(-2))

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """Mixture log density. x: (N, d) -> (N,)."""
        return torch.logsumexp(self._weighted_log_prob(x), dim=-1)

    def responsibilities(self, x: torch.Tensor) -> torch.Tensor:
        """Posterior component responsibilities. x: (N, d) -> (N, K)."""
        return torch.softmax(self._weighted_log_prob(x), dim=-1)

    def score(self, x: torch.Tensor,
              sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Average log-likelihood (the paper's fitness score, Eq. 2)."""
        lp = self.log_prob(x)
        if sample_weight is None:
            return lp.mean()
        return (lp * sample_weight).sum() / torch.clamp(
            sample_weight.sum(), min=1e-12)

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """Draw n samples from the mixture -> (n, d). ``generator`` must
        live on the model's device."""
        comp = torch.multinomial(self.weights, n, replacement=True,
                                 generator=generator)
        mu = self.means[comp]
        eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                          device=mu.device)
        if self.is_diagonal:
            return mu + torch.sqrt(self.covs[comp]) * eps
        chol = torch.linalg.cholesky(self.covs)[comp]
        return mu + (chol @ eps.unsqueeze(-1)).squeeze(-1)

    # ------------------------------------------------------------------
    def n_free_params(self) -> int:
        """Number of free parameters (for BIC)."""
        k, d = self.n_components, self.n_features
        cov_params = k * d if self.is_diagonal else k * d * (d + 1) // 2
        return (k - 1) + k * d + cov_params

    def bic(self, x: torch.Tensor,
            sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Bayesian Information Criterion (lower is better)."""
        lp = self.log_prob(x)
        if sample_weight is None:
            n = torch.tensor(float(x.shape[0]), dtype=lp.dtype,
                             device=lp.device)
            total_ll = lp.sum()
        else:
            n = sample_weight.sum()
            total_ll = (lp * sample_weight).sum()
        return self.n_free_params() * torch.log(n) - 2.0 * total_ll


# ----------------------------------------------------------------------
# Log-density functions (mirrored by repro_torch/kernels/gmm_logpdf)
# ----------------------------------------------------------------------

def _diag_component_log_prob(x: torch.Tensor, means: torch.Tensor,
                             variances: torch.Tensor) -> torch.Tensor:
    """log N(x | mu_k, diag(var_k)) for all k, via two matmuls.
    x (..., N, d), means/variances (..., K, d) -> (..., N, K).

    -2 log N = x^2 @ (1/var)^T - 2 x @ (mu/var)^T + sum(mu^2/var)
               + sum(log var) + d log 2pi
    """
    d = x.shape[-1]
    inv_var = 1.0 / variances
    a = (x * x) @ inv_var.transpose(-1, -2)
    b = x @ (means * inv_var).transpose(-1, -2)
    c = torch.sum(means * means * inv_var + torch.log(variances), dim=-1)
    return -0.5 * (a - 2.0 * b + c.unsqueeze(-2) + d * LOG_2PI)


def _full_component_log_prob(x: torch.Tensor, means: torch.Tensor,
                             covs: torch.Tensor) -> torch.Tensor:
    """log N(x | mu_k, Sigma_k) for all k via Cholesky.
    x (..., N, d), means (..., K, d), covs (..., K, d, d) -> (..., N, K)."""
    d = x.shape[-1]
    chol = torch.linalg.cholesky(covs)                       # (..., K, d, d)
    diff = x.unsqueeze(-2) - means.unsqueeze(-3)             # (..., N, K, d)
    rhs = diff.movedim(-3, -1)                               # (..., K, d, N)
    y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    maha = torch.sum(y * y, dim=-2).transpose(-1, -2)        # (..., N, K)
    logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    return -0.5 * (maha + logdet.unsqueeze(-2) + d * LOG_2PI)


# ----------------------------------------------------------------------
# Construction / merging helpers
# ----------------------------------------------------------------------

def merge_gmms(gmms: list[GMM], dataset_sizes) -> GMM:
    """FedGenGMM server-side merge (Algorithm 4.1 lines 21-29).

    Re-weights each client's component weights by |D_c| / |D| and
    concatenates all components into a single mixture, then normalizes.
    Clients may have different numbers of components.
    """
    device = gmms[0].means.device
    sizes = torch.as_tensor(dataset_sizes, dtype=torch.float32,
                            device=device)
    total = sizes.sum()
    ws = [g.weights * (s / total) for g, s in zip(gmms, sizes)]
    w = torch.cat(ws)
    w = w / w.sum()
    return GMM(w, torch.cat([g.means for g in gmms], dim=0),
               torch.cat([g.covs for g in gmms], dim=0))


def merge_gmms_stacked(weights: torch.Tensor, means: torch.Tensor,
                       covs: torch.Tensor, dataset_sizes) -> GMM:
    """Vectorized merge for stacked client params (C, K, ...)."""
    sizes = torch.as_tensor(dataset_sizes, dtype=weights.dtype,
                            device=weights.device)
    w = (weights * (sizes / sizes.sum())[:, None]).reshape(-1)
    w = w / w.sum()
    k = means.shape[0] * means.shape[1]
    return GMM(w, means.reshape(k, -1), covs.reshape((k,) + covs.shape[2:]))
