"""repro_torch.serve — the GMM scoring engine of the port (port of
``repro.serve``).

- :class:`ScoringEngine`: continuous batching over a fixed slot pool, each
  micro-batch one CUDA-graph replay of the log-density kernels on the
  card, with drain-and-install hot model swap;
- :class:`ModelStore`: the versioned publish/subscribe watcher over
  ``repro_torch.checkpoint.store`` (the JAX package's file format), so a
  trainer publishes a new global model each round and a live engine picks
  it up without dropping a request;
- :class:`ScoreConfig` / :class:`ScoreRequest` / :class:`ScoreResult`: the
  configuration and the request/response pair (every result carries the
  version of the model that scored it).

The public entry is ``repro_torch.api.Scorer``.
"""
from repro_torch.serve.engine import ScoringEngine
from repro_torch.serve.model_store import ModelStore, PublishedModel
from repro_torch.serve.slots import SlotPool
from repro_torch.serve.types import (SCORE_MODES, ScoreConfig, ScoreRequest,
                                     ScoreResult)

__all__ = [
    "ScoringEngine",
    "ModelStore",
    "PublishedModel",
    "SlotPool",
    "ScoreConfig",
    "ScoreRequest",
    "ScoreResult",
    "SCORE_MODES",
]
