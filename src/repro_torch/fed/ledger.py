"""The communication ledger of the federation runtime (port of
``repro/fed/ledger.py``).

Float counts are the primary unit (they are what the paper's Table 4
compares); ``itemsize`` converts them to wire bytes. An uplink transform
(``repro_torch.fed.transforms``) can change the uplink's wire dtype
(``uplink_itemsize``) and spend a privacy budget (``epsilon_spent``); an
asynchronous run (``repro_torch.fed.async_runtime``) records the staleness
of every update it consumed.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def dtype_itemsize(dtype) -> int:
    """Bytes per element of a payload dtype (float32 -> 4, ...)."""
    return torch.empty((), dtype=dtype).element_size()


class CommStats(NamedTuple):
    """Communication accounting for one federated training run.

    ``uplink_itemsize`` / ``downlink_itemsize`` override ``itemsize`` per
    direction (None: inherit), so an int8-quantized uplink beside a float32
    broadcast is counted honestly. ``epsilon_spent`` is the privacy budget
    the run consumed (a transform's per-round spend times the rounds run).
    ``staleness`` is an asynchronous run's per-update histogram
    ``((s, count), ...)`` sorted by ``s``: an update's staleness is the
    number of server combines between its dispatch and its consumption.
    Synchronous runs leave it empty."""
    rounds: int
    uplink_floats: int       # client -> server payload (total floats)
    downlink_floats: int     # server -> client payload (total floats)
    itemsize: int = 4        # bytes per payload element
    uplink_itemsize: Optional[int] = None    # override for the uplink
    downlink_itemsize: Optional[int] = None  # override for the downlink
    epsilon_spent: float = 0.0  # cumulative DP budget consumed
    staleness: tuple = ()    # ((staleness, count), ...) update histogram

    @property
    def uplink_bytes(self) -> int:
        size = self.itemsize if self.uplink_itemsize is None \
            else self.uplink_itemsize
        return self.uplink_floats * size

    @property
    def downlink_bytes(self) -> int:
        size = self.itemsize if self.downlink_itemsize is None \
            else self.downlink_itemsize
        return self.downlink_floats * size

    @property
    def payload_bytes(self) -> int:
        """Total wire volume (uplink + downlink) in bytes."""
        return self.uplink_bytes + self.downlink_bytes

    @property
    def total_mb(self) -> float:
        """Total wire volume in MiB."""
        return self.payload_bytes / 2**20

    @property
    def mean_staleness(self) -> float:
        """Average per-update staleness of an async run (0.0 when the
        histogram is empty)."""
        n = sum(count for _, count in self.staleness)
        if n == 0:
            return 0.0
        return sum(s * count for s, count in self.staleness) / n


class RoundPayload(NamedTuple):
    """What one communication round moves, summed over the cohort; the
    round loop multiplies by the realized round count and adds the
    once-per-run ``extra_*`` traffic (warm-start statistics, the round-0
    broadcast, a final rescore) once. The transform fields
    (``uplink_itemsize``, ``epsilon_per_round``) and an async run's
    realized ``staleness`` are filled in by the round loop."""
    uplink_floats: int
    downlink_floats: int
    itemsize: int = 4
    extra_uplink_floats: int = 0
    extra_downlink_floats: int = 0
    uplink_itemsize: Optional[int] = None
    downlink_itemsize: Optional[int] = None
    epsilon_per_round: float = 0.0
    staleness: tuple = ()

    def totals(self, rounds: int) -> CommStats:
        return CommStats(
            rounds=rounds,
            uplink_floats=rounds * self.uplink_floats
            + self.extra_uplink_floats,
            downlink_floats=rounds * self.downlink_floats
            + self.extra_downlink_floats,
            itemsize=self.itemsize,
            uplink_itemsize=self.uplink_itemsize,
            downlink_itemsize=self.downlink_itemsize,
            epsilon_spent=rounds * self.epsilon_per_round,
            staleness=self.staleness)


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
