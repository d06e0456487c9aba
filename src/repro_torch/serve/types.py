"""Request/response types and the one scoring configuration of the serving
engine (port of ``repro/serve/types.py``).

A scoring request is a batch of feature rows; a response is the per-row
scores and the version tag of the model that scored them. Everything here
is host data; the device-facing contract (one fixed ``(slots,
rows_per_slot, d)`` slab) lives in :class:`~repro_torch.serve.slots.SlotPool`
and the engine.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

#: Scoring modes: per-row mixture log density, per-row anomaly score (its
#: negation: higher is more anomalous, the paper's §5.4 detector), or
#: per-row posterior responsibilities (an (n, K) block per request).
SCORE_MODES = ("log_prob", "anomaly", "responsibilities")

#: Engine backends, as in training (``repro_torch.core.config
#: .resolve_backend``): "auto" picks the CUDA kernels on a Hopper card and
#: the eager reference on the CPU.
SERVE_BACKENDS = ("auto", "reference", "fused")


@dataclasses.dataclass(frozen=True)
class ScoreConfig:
    """The one validated serving configuration (frozen, hashable).

    - ``mode``: ``"log_prob"`` (per-row mixture log density, f32, ``(n,)``
      a request), ``"anomaly"`` (its negation) or ``"responsibilities"``
      (the posterior ``(n, K)`` block a request).
    - ``slots``: requests in flight at once (the fixed slot pool).
    - ``rows_per_slot``: rows a slot feeds each micro-batch. Longer
      requests stream through their slot over several micro-batches;
      shorter ones are zero-padded to the fixed slab.
    - ``backend``: "auto" | "reference" | "fused". "fused" runs the CUDA
      log-density kernels on the card (their plain versions on the CPU),
      one CUDA-graph replay a micro-batch.
    - ``poll_every``: poll the attached model store every this many
      micro-batches.
    - ``device``: "cuda" (default) or "cpu".
    """

    mode: str = "log_prob"
    slots: int = 8
    rows_per_slot: int = 512
    backend: str = "auto"
    poll_every: int = 1
    device: str = "cuda"

    def __post_init__(self):
        if self.mode not in SCORE_MODES:
            raise ValueError(
                f"mode must be one of {SCORE_MODES}, got {self.mode!r}")
        if self.backend not in SERVE_BACKENDS:
            raise ValueError(
                f"backend must be one of {SERVE_BACKENDS}, "
                f"got {self.backend!r}")
        for name in ("slots", "rows_per_slot", "poll_every"):
            v = getattr(self, name)
            if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"{name} must be a positive int, got {v!r}")
        try:
            kind = torch.device(self.device).type
        except RuntimeError:
            kind = None
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', "
                             f"got {self.device!r}")


@dataclasses.dataclass(frozen=True)
class ScoreRequest:
    """One scoring request: ``rid`` (caller-chosen, echoed in the result)
    and ``rows``, an ``(n, d)`` float array (``n >= 0``; ``d`` is checked
    against the served model at submit), kept as a numpy f32 array."""

    rid: int
    rows: np.ndarray

    def __post_init__(self):
        rows = np.asarray(self.rows, dtype=np.float32)
        if rows.ndim != 2:
            raise ValueError(
                f"request rows must be (n, d), got shape {rows.shape}")
        object.__setattr__(self, "rows", rows)

    @property
    def num_rows(self) -> int:
        """Number of feature rows in this request."""
        return self.rows.shape[0]


@dataclasses.dataclass(frozen=True)
class ScoreResult:
    """One completed request: per-row ``scores`` (``(n,)`` f32, or ``(n,
    K)`` for responsibilities), the ``model_version`` of the one model that
    scored every row, and ``latency_s`` from the request's admission into
    a slot to its retirement (time in the queue is not in it, as in the
    JAX package)."""

    rid: int
    scores: np.ndarray
    model_version: Union[int, str]
    latency_s: float

    @property
    def num_rows(self) -> int:
        """Number of scored rows (the request's row count)."""
        return self.scores.shape[0]
