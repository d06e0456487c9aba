"""Checkpoints of nested tensors, and the versioned publish/subscribe stream
the serving engine hot-swaps on (port of ``repro/checkpoint/store.py``).

The files are those of the JAX package, so a stream one package publishes
loads in the other: ``<path>.npz`` holds one array per leaf under its flat
key, ``<path>.json`` the metadata, and a published stream keeps version v
at ``<root>/model-<v:06d>.{npz,json}`` with ``<root>/LATEST`` naming the
newest. Flat keys are the JAX package's pytree key paths joined by ``/``:
a dict's keys in sorted order, a list's or tuple's indices, and a
:class:`~repro_torch.core.gmm.GMM` as ``0``, ``1``, ``2`` (weights, means,
covs); ``None`` holds no leaf. Those are the containers flattened here;
anything else is a leaf (a tensor, a numpy array or a number).

Two layers:

- :func:`save_checkpoint` / :func:`load_checkpoint`: one named checkpoint.
  ``load_checkpoint`` restores into the structure of a ``like`` template,
  onto each template leaf's device and dtype, and raises
  :class:`ValueError` naming the flat key of a missing leaf or of a shape
  mismatch.
- :func:`publish_checkpoint` / :func:`latest_version` /
  :func:`load_published`: a monotonically versioned stream in one
  directory. The payload files are written under hidden temporary names and
  ``os.replace``-d into place, and the ``LATEST`` pointer is replaced last,
  so a subscriber that reads ``LATEST`` never meets a version whose payload
  is missing or half-written (single publisher).

npz has no bfloat16: such leaves (and any other dtype numpy lacks) are
stored as float32, while the ``leaves`` table of a published version keeps
the original dtype name (``"bfloat16"``). bf16 -> f32 -> bf16 is exact, so
the round trip is lossless.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.gmm import GMM

# Version v of a published stream lives at <root>/model-<v:06d>.{npz,json};
# <root>/LATEST holds {"version": v, "stem": "model-<v:06d>"}.
LATEST_NAME = "LATEST"
_STEM_FMT = "model-{:06d}"

# dtypes npz stores as they are; every other one is stored as float32
_NPZ_DTYPES = (np.float64, np.float32, np.float16, np.int64, np.int32,
               np.int16, np.int8, np.uint8, np.bool_)
_TORCH_NPZ_DTYPES = (torch.float64, torch.float32, torch.float16,
                     torch.int64, torch.int32, torch.int16, torch.int8,
                     torch.uint8, torch.bool)


def _children(tree):
    """(key, child) pairs of a container in the JAX package's flattening
    order, or None for a leaf."""
    if isinstance(tree, GMM):
        return [("0", tree.weights), ("1", tree.means), ("2", tree.covs)]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _map_leaves(tree, fn, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(flat key, leaf)``."""
    if tree is None:
        return None
    children = _children(tree)
    if children is None:
        return fn(prefix, tree)
    new = {key: _map_leaves(child, fn, f"{prefix}/{key}" if prefix else key)
           for key, child in children}
    if isinstance(tree, GMM):
        return GMM(new["0"], new["1"], new["2"])
    if isinstance(tree, dict):
        return {k: new[str(k)] for k in tree}
    return type(tree)(new[str(i)] for i in range(len(tree)))


def _flat_leaves(tree) -> list:
    """(flat key, leaf) of every leaf of ``tree``, in flattening order."""
    found = []
    _map_leaves(tree, lambda key, leaf: found.append((key, leaf)))
    return found


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype not in _TORCH_NPZ_DTYPES:
            t = t.float()
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype not in _NPZ_DTYPES:
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree) -> dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _flat_leaves(tree)}


def _shape_dtype(leaf) -> tuple[tuple, str]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    return arr.shape, str(arr.dtype)


def leaf_spec(tree) -> dict[str, dict]:
    """Flat key -> {"shape", "dtype"} of every leaf, with the ORIGINAL dtype
    names (bf16 stays "bfloat16" though the npz stores f32), as the JAX
    package writes them. Published beside every version, so a subscriber
    can rebuild a ``like`` template from the metadata alone."""
    spec = {}
    for key, leaf in _flat_leaves(tree):
        shape, dtype = _shape_dtype(leaf)
        spec[key] = {"shape": list(shape), "dtype": dtype}
    return spec


def save_checkpoint(path: str, params, metadata: dict | None = None):
    """Write ``params`` to ``<path>.npz`` (and ``<path>.json`` when
    ``metadata`` is given), one array per leaf under its flat key."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(p.with_suffix(".npz"), **_flatten(params))
    if metadata is not None:
        p.with_suffix(".json").write_text(json.dumps(metadata, indent=2))


def load_checkpoint(path: str, like):
    """Restore ``<path>.npz`` into the structure of ``like`` ->
    ``(params, metadata)``.

    A tensor leaf is restored with the dtype and on the device of the
    template's leaf; a numpy or number leaf as a numpy array of its dtype.
    Raises :class:`ValueError` naming the flat key when the checkpoint lacks
    a leaf the template has, or when a stored leaf's shape differs."""
    p = Path(path)
    npz = p.with_suffix(".npz")

    def restore(key, leaf):
        if key not in data.files:
            raise ValueError(
                f"checkpoint {npz} is missing pytree leaf {key!r}; stored "
                f"leaves: {sorted(data.files)}")
        arr = data[key]
        shape, _ = _shape_dtype(leaf)
        if arr.shape != shape:
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {arr.shape} but the "
                f"template expects {shape} (checkpoint: {npz})")
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(arr).to(device=leaf.device,
                                            dtype=leaf.dtype)
        return arr.astype(np.asarray(leaf).dtype)

    with np.load(npz) as data:
        params = _map_leaves(like, restore)
    meta = {}
    if p.with_suffix(".json").exists():
        meta = json.loads(p.with_suffix(".json").read_text())
    return params, meta


# ----------------------------------------------------------------------
# Versioned publish/subscribe (the serving hot-swap seam)
# ----------------------------------------------------------------------

def latest_version(root: str) -> int | None:
    """Highest published version in ``root``, or None when nothing has
    been published. One small file read in the normal case; a missing
    ``LATEST`` pointer (a publisher that stopped between the payload and
    pointer renames) falls back to scanning the payloads, so a torn pointer
    never wedges the stream or reuses a version number."""
    pointer = Path(root) / LATEST_NAME
    try:
        return int(json.loads(pointer.read_text())["version"])
    except FileNotFoundError:
        versions = [int(p.stem.split("-")[-1])
                    for p in Path(root).glob("model-*.npz")]
        return max(versions) if versions else None


def publish_checkpoint(root: str, params, metadata: dict | None = None) -> int:
    """Publish ``params`` as the next version of the stream in ``root`` ->
    the new version number (1-based, monotonic).

    The npz and json payloads land under hidden temporary names, each is
    ``os.replace``-d to its final name, and the ``LATEST`` pointer is
    replaced last. The json metadata gains ``version`` and the ``leaves``
    shape/dtype table (:func:`leaf_spec`)."""
    rootp = Path(root)
    rootp.mkdir(parents=True, exist_ok=True)
    version = (latest_version(root) or 0) + 1
    stem = _STEM_FMT.format(version)
    meta = dict(metadata or {})
    meta["version"] = version
    meta["leaves"] = leaf_spec(params)

    tmp = rootp / f".tmp-{stem}"
    np.savez_compressed(tmp.with_suffix(".npz"), **_flatten(params))
    tmp.with_suffix(".json").write_text(json.dumps(meta, indent=2))
    os.replace(tmp.with_suffix(".npz"), (rootp / stem).with_suffix(".npz"))
    os.replace(tmp.with_suffix(".json"), (rootp / stem).with_suffix(".json"))

    ptr_tmp = rootp / (".tmp-" + LATEST_NAME)
    ptr_tmp.write_text(json.dumps({"version": version, "stem": stem}))
    os.replace(ptr_tmp, rootp / LATEST_NAME)
    return version


def load_published(root: str, like, version: int | None = None):
    """Load one version of a published stream -> ``(params, metadata,
    version)``, restored into ``like`` as :func:`load_checkpoint` does.
    ``version=None`` loads the latest; raises :class:`FileNotFoundError`
    on an empty stream and :class:`ValueError` for a version that was never
    published."""
    if version is None:
        version = latest_version(root)
        if version is None:
            raise FileNotFoundError(
                f"no published checkpoint under {root!r} (no "
                f"{LATEST_NAME} pointer)")
    stem = Path(root) / _STEM_FMT.format(version)
    if not stem.with_suffix(".npz").exists():
        raise ValueError(
            f"version {version} was never published under {root!r} "
            f"(latest is {latest_version(root)})")
    params, meta = load_checkpoint(str(stem), like)
    return params, meta, int(version)
