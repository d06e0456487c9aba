"""The serving facade: :class:`Scorer`, which scores rows against a
published global model without the engine's plumbing (port of
``repro/api/serving.py``)::

    from repro_torch.api import Scorer

    scorer = Scorer.from_checkpoint("runs/models", "anomaly")  # on cuda
    anomaly = scorer.score(x)                                  # (n,) f32

A ``Scorer`` built with ``follow=True`` (the default of
``from_checkpoint``) keeps watching the model store: when a new round's
global model is published, the next ``score`` call is served by it, and
:attr:`Scorer.model_version` says which version that was. The store may be
one the JAX package's ``repro.serve.ModelStore`` publishes into.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

from repro_torch.core.gmm import GMM
from repro_torch.serve.engine import ScoringEngine
from repro_torch.serve.model_store import ModelStore
from repro_torch.serve.types import ScoreConfig, ScoreRequest


class Scorer:
    """Batch-in, scores-out facade over the continuous-batching engine.

    - ``gmm``: the model to serve (a fitted estimator's ``gmm_``, a
      federated result's ``global_gmm``, or a loaded checkpoint).
    - ``mode``: ``"log_prob"``, ``"anomaly"`` (its negation: higher is more
      anomalous, the paper's §5.4 detector) or ``"responsibilities"``.
    - ``slots`` / ``rows_per_slot`` / ``backend`` / ``poll_every`` /
      ``device``: engine knobs, validated by
      :class:`repro_torch.serve.ScoreConfig` (``device`` is "cuda" unless
      the caller asks for "cpu").
    - ``version``: tag reported for this model (a store-backed scorer
      reports the published version instead).
    """

    def __init__(self, gmm: GMM, mode: str = "log_prob", *,
                 slots: int = 8, rows_per_slot: int = 512,
                 backend: str = "auto", poll_every: int = 1,
                 device: str = "cuda", version: Union[int, str] = "v0",
                 _store=None):
        config = ScoreConfig(mode=mode, slots=slots,
                             rows_per_slot=rows_per_slot, backend=backend,
                             poll_every=poll_every, device=device)
        self._engine = ScoringEngine(gmm, config, version=version,
                                     store=_store)
        self._next_rid = 0

    @classmethod
    def from_checkpoint(cls, root, mode: str = "log_prob", *,
                        version: Optional[int] = None, follow: bool = True,
                        **knobs) -> "Scorer":
        """A scorer over a versioned model-store directory.

        - ``version=None`` serves the latest published model; an int pins
          that version (and never follows).
        - ``follow=True`` keeps the subscription: newly published models
          hot-swap in between batches.
        - ``**knobs`` are the :class:`Scorer` engine knobs (``slots=...``,
          ``device=...``, ...).

        Raises :class:`FileNotFoundError` when nothing has been published
        under ``root``.
        """
        store = ModelStore(root, device=knobs.get("device", "cuda"))
        if version is not None:
            published = store.load(version)
            follow = False
        else:
            published = store.latest()
            if published is None:
                raise FileNotFoundError(
                    f"no published model under {str(root)!r}")
        return cls(published.gmm, mode, version=published.version,
                   _store=store if follow else None, **knobs)

    @property
    def model_version(self) -> Union[int, str]:
        """Version tag of the model being served."""
        return self._engine.version

    @property
    def gmm(self) -> GMM:
        """The served model."""
        return self._engine.gmm

    @property
    def engine(self) -> ScoringEngine:
        """The underlying :class:`repro_torch.serve.ScoringEngine`, for the
        streaming interface (``submit`` / ``step``)."""
        return self._engine

    def score(self, rows) -> np.ndarray:
        """Score one batch of rows -> per-row scores, row-aligned with the
        input: ``(n,)`` f32 for log_prob/anomaly, ``(n, K)`` f32 for
        responsibilities. Polls the attached store first, so a
        store-following scorer serves the newest published model."""
        rid = self._next_rid
        self._next_rid += 1
        self._engine.submit(ScoreRequest(rid, np.asarray(rows)))
        results = self._engine.drain()
        (result,) = [r for r in results if r.rid == rid]
        return result.scores
