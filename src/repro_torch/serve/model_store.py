"""The hot-swap model watcher: a GMM-typed publish/subscribe view over the
versioned checkpoint stream of ``repro_torch.checkpoint.store`` (port of
``repro/serve/model_store.py``).

Whatever produces a new global model calls :meth:`ModelStore.publish`, one
atomic versioned checkpoint a round. The serving engine holds the
subscriber half: it calls :meth:`ModelStore.poll` between micro-batches,
which returns a newly published model exactly once and always jumps to
the latest version. Shapes and dtypes ride in the published metadata, so a
store directory describes itself. The files are the JAX package's, so
either package may publish what the other serves.

A subscriber restores models onto its ``device`` ("cuda" unless the
caller asks for "cpu"); publishing needs none.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Union

import torch

from repro_torch.checkpoint.store import (_STEM_FMT, latest_version,
                                          load_published, publish_checkpoint)
from repro_torch.core.config import resolve_device
from repro_torch.core.gmm import GMM

# The flat checkpoint keys of a GMM's leaves (weights, means, covs), as
# the JAX package's pytree flattening names them.
_GMM_LEAF_KEYS = ("0", "1", "2")


def _gmm_template(leaves: dict, device: torch.device) -> GMM:
    """Zero-filled GMM on ``device`` with the shapes and dtypes of a
    published version's ``leaves`` metadata: the ``like`` template the
    loader restores into (which keeps bf16 leaves bf16)."""
    missing = [k for k in _GMM_LEAF_KEYS if k not in leaves]
    if missing:
        raise ValueError(
            f"published checkpoint is not a GMM: metadata is missing "
            f"leaf keys {missing} (has {sorted(leaves)})")
    w, mu, cov = (torch.zeros(tuple(leaves[k]["shape"]),
                              dtype=getattr(torch, leaves[k]["dtype"]),
                              device=device)
                  for k in _GMM_LEAF_KEYS)
    return GMM(w, mu, cov)


@dataclasses.dataclass(frozen=True)
class PublishedModel:
    """One published global model: its ``version``, the restored
    :class:`GMM`, and the publisher's metadata (with ``version`` and the
    ``leaves`` table)."""

    version: int
    gmm: GMM
    metadata: dict


class ModelStore:
    """One directory = one versioned stream of global GMMs.

    - ``publish(gmm, metadata)`` -> new version number (atomic; one
      publisher).
    - ``poll()`` -> a :class:`PublishedModel` the first time a version newer
      than anything this object has returned appears, else None.
    - ``latest()`` / ``load(version)``: explicit reads (``latest`` gives None
      on an empty stream; ``load`` raises for a version never published).

    The seen-version cursor belongs to each ``ModelStore`` object; the
    directory is the shared truth.
    """

    def __init__(self, root: Union[str, Path], device: str = "cuda"):
        self.root = str(root)
        self.device = device
        self._seen = 0

    def publish(self, gmm: GMM, metadata: Optional[dict] = None) -> int:
        """Publish a new global model -> its version (1-based, monotonic);
        ``metadata`` is stored in the version's json beside the generated
        ``version`` and ``leaves`` entries."""
        if not isinstance(gmm, GMM):
            raise TypeError(
                f"ModelStore publishes repro_torch.core.gmm.GMM models, got "
                f"{type(gmm).__name__}")
        return publish_checkpoint(self.root, gmm, metadata)

    def latest_version(self) -> Optional[int]:
        """Highest published version, or None on an empty stream (one small
        file read; safe to call every micro-batch)."""
        return latest_version(self.root)

    def load(self, version: Optional[int] = None) -> PublishedModel:
        """Load one version (None = latest) onto this store's device ->
        :class:`PublishedModel`. Advances the seen-cursor, so a later
        ``poll`` only fires on something newer still."""
        meta = json.loads(self._meta_path(version).read_text())
        like = _gmm_template(meta["leaves"], resolve_device(self.device))
        gmm, meta, v = load_published(self.root, like, meta["version"])
        self._seen = max(self._seen, v)
        return PublishedModel(v, gmm, meta)

    def latest(self) -> Optional[PublishedModel]:
        """The newest published model, or None on an empty stream."""
        if self.latest_version() is None:
            return None
        return self.load(None)

    def poll(self) -> Optional[PublishedModel]:
        """The newest published model IF it is newer than anything this
        subscriber has seen, else None. Versions published since the last
        poll are skipped, not replayed."""
        v = self.latest_version()
        if v is None or v <= self._seen:
            return None
        return self.load(v)

    def _meta_path(self, version: Optional[int]) -> Path:
        if version is None:
            version = self.latest_version()
            if version is None:
                raise FileNotFoundError(
                    f"no published model under {self.root!r}")
        path = Path(self.root) / (_STEM_FMT.format(version) + ".json")
        if not path.exists():
            raise ValueError(
                f"version {version} was never published under "
                f"{self.root!r} (latest is {self.latest_version()})")
        return path
