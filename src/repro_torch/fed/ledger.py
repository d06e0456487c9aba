"""The communication ledger of the federation runtime (port of
``repro/fed/ledger.py``; the transform and async fields, ``uplink_itemsize``,
``epsilon_per_round`` and ``staleness``, come with those slices).

Float counts are the primary unit (they are what the paper's Table 4
compares); ``itemsize`` converts them to wire bytes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def dtype_itemsize(dtype) -> int:
    """Bytes per element of a payload dtype (float32 -> 4, ...)."""
    return torch.empty((), dtype=dtype).element_size()


class CommStats(NamedTuple):
    """Communication accounting for one federated training run."""
    rounds: int
    uplink_floats: int       # client -> server payload (total floats)
    downlink_floats: int     # server -> client payload (total floats)
    itemsize: int = 4        # bytes per payload element

    @property
    def uplink_bytes(self) -> int:
        return self.uplink_floats * self.itemsize

    @property
    def downlink_bytes(self) -> int:
        return self.downlink_floats * self.itemsize

    @property
    def payload_bytes(self) -> int:
        """Total wire volume (uplink + downlink) in bytes."""
        return self.uplink_bytes + self.downlink_bytes

    @property
    def total_mb(self) -> float:
        """Total wire volume in MiB."""
        return self.payload_bytes / 2**20


class RoundPayload(NamedTuple):
    """What one communication round moves, summed over the cohort; the
    round loop multiplies by the realized round count and adds the
    once-per-run ``extra_*`` traffic (warm-start statistics, the round-0
    broadcast, a final rescore) once."""
    uplink_floats: int
    downlink_floats: int
    itemsize: int = 4
    extra_uplink_floats: int = 0
    extra_downlink_floats: int = 0

    def totals(self, rounds: int) -> CommStats:
        return CommStats(
            rounds=rounds,
            uplink_floats=rounds * self.uplink_floats
            + self.extra_uplink_floats,
            downlink_floats=rounds * self.downlink_floats
            + self.extra_downlink_floats,
            itemsize=self.itemsize)


def gmm_payload_floats(k: int, d: int, diagonal: bool) -> int:
    """One GMM's parameter block: weights (k) + means (k·d) + covariances
    (k·d diag / k·d² full) — the FedGenGMM uplink and every broadcast."""
    cov = k * d if diagonal else k * d * d
    return k + k * d + cov


def payload_floats(gmm) -> int:
    """:func:`gmm_payload_floats` of a concrete (unstacked) model."""
    k, d = gmm.means.shape
    return gmm_payload_floats(k, d, gmm.is_diagonal)


def stats_payload_floats(k: int, d: int, diagonal: bool) -> int:
    """One client's EM ``SufficientStats``: s0 (k) + s1 (k·d) + s2 (k·d
    diag / k·d² full) + loglik + wsum — the DEM/FedEM per-round uplink."""
    cov = k * d if diagonal else k * d * d
    return k + k * d + cov + 2


def label_payload_floats(k: int, d: int) -> int:
    """One client's hard-assignment label statistics: counts (k) + sums
    (k·d) + inertia — the federated k-means per-round uplink."""
    return k + k * d + 1
