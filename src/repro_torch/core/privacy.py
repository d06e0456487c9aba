"""Differential privacy for the FedGenGMM uplink (port of
``repro/core/privacy.py``; the paper's §4.4 leaves it as future work).

The one-shot structure is DP-friendly: the whole privacy budget is spent on
a single release of the local GMM parameters, where iterative methods split
epsilon across rounds. The mechanism is the analytic Gaussian mechanism on
features normalized to [0, 1]^d, split three ways over weights, means and
variances; it lives in :class:`repro_torch.fed.transforms.GaussianDP`, the
uplink-transform seam every strategy shares. The entry points here release
one client's (or every client's) fitted parameters under a
:class:`DPConfig` budget, on the device of the model they are given. They
take a seed where the JAX package takes a key.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.config import derive_seed
from repro_torch.core.gmm import GMM
from repro_torch.fed.transforms import GaussianDP, UplinkKey, gaussian_sigma

__all__ = ["DPConfig", "gaussian_sigma", "privatize_clients",
           "privatize_gmm"]


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """The (epsilon, delta) budget of one DP release, validated at
    construction: ``epsilon > 0``, ``delta`` in (0, 1), ``min_count > 0``
    (the floor on per-component effective counts that bounds the mean and
    variance sensitivities)."""

    epsilon: float = 1.0
    delta: float = 1e-5
    min_count: float = 8.0

    def __post_init__(self):
        if not float(self.epsilon) > 0.0:
            raise ValueError(
                f"DPConfig.epsilon must be > 0, got {self.epsilon}")
        if not 0.0 < float(self.delta) < 1.0:
            raise ValueError(
                f"DPConfig.delta must be in (0, 1), got {self.delta}")
        if not float(self.min_count) > 0.0:
            raise ValueError(
                f"DPConfig.min_count must be > 0, got {self.min_count}")

    def transform(self, seed: int = 0) -> GaussianDP:
        """The one-shot (``rounds=1``) uplink transform of this budget."""
        return GaussianDP(epsilon=float(self.epsilon),
                          delta=float(self.delta), rounds=1,
                          min_count=float(self.min_count), seed=int(seed))


def privatize_gmm(seed: int, gmm: GMM, n_samples: float,
                  dp: DPConfig) -> GMM:
    """Release an (epsilon, delta)-DP view of one client's GMM parameters
    (diagonal covariance, features in [0, 1]^d), drawn from ``seed`` on the
    model's device; a full covariance raises ``ValueError``."""
    if not gmm.is_diagonal:
        raise ValueError(
            f"DP release supports diagonal covariance; this GMM carries "
            f"a 'full' covariance (covs shape {tuple(gmm.covs.shape)})")
    t = dp.transform()
    released, _ = t.apply(UplinkKey(int(seed), 0), t.traced(),
                          (gmm, n_samples), 0, None)
    return released


def privatize_clients(seed: int, gmms: list[GMM], sizes,
                      dp: DPConfig) -> list[GMM]:
    """Per-client DP release of a list of fitted GMMs (one budget each;
    client ``i`` draws from ``derive_seed(seed, i)``)."""
    return [privatize_gmm(derive_seed(seed, i), g, float(n), dp)
            for i, (g, n) in enumerate(zip(gmms, sizes))]
