"""`FitConfig`, the one training configuration every estimator consumes,
the backend, device and chunk resolvers the engine shares, and the
input-type predicates of the out-of-core path (port of
``repro/core/config.py``).

The port adds ``device``. Entry points run on ``"cuda"`` unless the caller
asks for ``"cpu"``; asking for CUDA where there is none raises, and nothing
carries on on the CPU instead.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Union

import numpy as np
import torch

ENGINE_BACKENDS = ("auto", "reference", "fused")
COVARIANCE_TYPES = ("diag", "full")
INIT_STRATEGIES = ("auto", "kmeans", "separated", "pilot", "fed-kmeans")

TOL_DEFAULTS = {"em": 1e-3, "kmeans": 1e-4}
MAX_ITER_DEFAULTS = {"em": 200, "kmeans": 100}

# Block size of the DataSource paths under chunk_size="auto": a source has
# no full batch to fall back to, so it streams at this granularity.
DEFAULT_SOURCE_CHUNK = 65536


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA must be present when asked
    for. On CUDA, float32 matmuls are pinned to full float32 (no TF32): the
    identity ``x²@A + x@B + c`` cancels large terms."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device}")
    return device


def fused_native(device: torch.device) -> bool:
    """True where the hand-written kernels run: a CUDA device of compute
    capability 9.x (Hopper, built for sm_90a)."""
    device = torch.device(device)
    return (device.type == "cuda"
            and torch.cuda.get_device_capability(device)[0] == 9)


def resolve_backend(backend: str, device, fused_supported: bool = True) -> str:
    """Resolve the engine knob to a concrete implementation.

    ``auto`` picks ``fused`` (the CUDA kernels) on a Hopper card and
    ``reference`` (eager torch ops) on the CPU; on any other CUDA card it
    raises, since the kernels are built for sm_90a only and the plain path
    there must be asked for by name. An explicit ``fused`` on CPU tensors
    runs the kernels' plain versions through the same packing, which is how
    the CPU tests reach that path. Ops whose kernel does not support the
    configuration (``fused_supported=False``, full covariance) run the
    reference.
    """
    if backend not in ENGINE_BACKENDS:
        raise ValueError(f"engine backend must be one of {ENGINE_BACKENDS}, "
                         f"got {backend!r}")
    if not fused_supported:
        return "reference"
    if backend == "auto":
        device = torch.device(device)
        if device.type == "cpu":
            return "reference"
        if fused_native(device):
            return "fused"
        raise RuntimeError(
            f"backend 'auto' found a CUDA device of capability "
            f"{torch.cuda.get_device_capability(device)}; the kernels are "
            f"built for 9.x (sm_90a) only. Pass backend='reference' to run "
            f"the plain PyTorch path on this card")
    return backend


def resolve_estep_backend(estep_backend: str, is_diagonal: bool,
                          device) -> str:
    """E-step flavour of :func:`resolve_backend`: the fused kernel only
    implements diagonal covariance."""
    return resolve_backend(estep_backend, device, fused_supported=is_diagonal)


def resolve_source_chunk(chunk_size) -> int:
    """The one ``chunk_size`` rule of the source paths: ``None`` means
    :data:`DEFAULT_SOURCE_CHUNK`; an explicit value must be positive
    (``chunk_size=0`` is a caller's bug, not a request for the default)."""
    if chunk_size is None:
        return DEFAULT_SOURCE_CHUNK
    chunk_size = int(chunk_size)
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    return chunk_size


def require_array_weights(sample_weight, what: str) -> None:
    """The sample-weight rule: weights mask padded fixed-shape client
    arrays, so they belong to resident inputs only; a DataSource block
    stream is never padded and every source row has weight 1."""
    if sample_weight is not None:
        raise ValueError(
            f"{what}: sample_weight is only supported on resident-array "
            f"inputs. Weights exist to mask padded fixed-shape client "
            f"arrays; DataSource block streams are never padded, so every "
            f"source row has weight 1 by design. Represent ragged client "
            f"shards directly with repro.data.sources.ConcatSource and "
            f"drop the weights.")


def is_source(data) -> bool:
    """True if ``data`` is a single out-of-core DataSource."""
    from repro_torch.data.sources import DataSource
    return isinstance(data, DataSource)


def is_source_list(data) -> bool:
    """True if ``data`` is a non-empty list or tuple of per-client
    DataSources (the federated out-of-core input)."""
    from repro_torch.data.sources import DataSource
    return (isinstance(data, (list, tuple)) and len(data) > 0
            and all(isinstance(s, DataSource) for s in data))


def derive_seed(seed: int, *path) -> int:
    """The seed of one stage or member below ``seed`` (the port's
    ``jax.random.fold_in``): ``path`` holds stage names and member
    indices, e.g. ``derive_seed(seed, "local", client)``."""
    words = [int(seed)] + [zlib.crc32(p.encode()) if isinstance(p, str)
                           else int(p) for p in path]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def make_generator(seed: int, device="cpu") -> torch.Generator:
    """An explicit torch generator on ``device``, seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


def _integral(value, name: str, minimum: int) -> int:
    if isinstance(value, bool) or int(value) != value:
        raise ValueError(f"{name} must be an integer, got {value!r}")
    if int(value) < minimum:
        raise ValueError(f"{name} must be >= {minimum}, got {value}")
    return int(value)


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Frozen, validated-at-construction training configuration.

    backend : "auto" | "reference" | "fused" (see :func:`resolve_backend`);
        the E-step, the k-means assignment and scoring all follow it.
    chunk_size : "auto" or a positive int (rows per chunk of the streaming
        engine, O(chunk·K) working set). "auto" is the full batch on
        resident arrays and :data:`DEFAULT_SOURCE_CHUNK` rows on sources.
    covariance_type : "diag" | "full".
    reg_covar : covariance floor added at every M-step.
    tol, max_iter : "auto" resolves per algorithm (:data:`TOL_DEFAULTS`,
        :data:`MAX_ITER_DEFAULTS`); explicit values apply everywhere.
    init : "auto" | "kmeans" | "separated" | "pilot" | "fed-kmeans": the
        initialization strategy. Single-model fits and FedGenGMM's local
        fits take "auto"/"kmeans" (k-means); DEM and FedEM take the paper's
        three schemes ("auto" = "fed-kmeans" on a split); FedKMeans takes
        "fed-kmeans" or "separated".
    seed : the root of every generator an estimator derives.
    device : "cuda" (default) or "cpu".
    """

    backend: str = "auto"
    chunk_size: Union[int, str] = "auto"
    covariance_type: str = "diag"
    reg_covar: float = 1e-6
    tol: Union[float, str] = "auto"
    max_iter: Union[int, str] = "auto"
    init: str = "auto"
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if self.backend not in ENGINE_BACKENDS:
            raise ValueError(f"engine backend must be one of "
                             f"{ENGINE_BACKENDS}, got {self.backend!r}")
        if self.chunk_size != "auto":
            if isinstance(self.chunk_size, str):
                raise ValueError(f"chunk_size must be 'auto' or a positive "
                                 f"int, got {self.chunk_size!r}")
            object.__setattr__(self, "chunk_size",
                               _integral(self.chunk_size, "chunk_size", 1))
        if self.covariance_type not in COVARIANCE_TYPES:
            raise ValueError(f"covariance_type must be one of "
                             f"{COVARIANCE_TYPES}, got "
                             f"{self.covariance_type!r}")
        if not float(self.reg_covar) >= 0.0:
            raise ValueError(f"reg_covar must be >= 0, got {self.reg_covar}")
        object.__setattr__(self, "reg_covar", float(self.reg_covar))
        if self.tol != "auto":
            if isinstance(self.tol, str) or not float(self.tol) >= 0.0:
                raise ValueError(f"tol must be 'auto' or a float >= 0, "
                                 f"got {self.tol!r}")
            object.__setattr__(self, "tol", float(self.tol))
        if self.max_iter != "auto":
            if isinstance(self.max_iter, str):
                raise ValueError(f"max_iter must be 'auto' or an integer "
                                 f">= 1, got {self.max_iter!r}")
            object.__setattr__(self, "max_iter",
                               _integral(self.max_iter, "max_iter", 1))
        if self.init not in INIT_STRATEGIES:
            raise ValueError(f"init must be one of {INIT_STRATEGIES}, "
                             f"got {self.init!r}")
        object.__setattr__(self, "seed", _integral(self.seed, "seed", 0))
        try:
            kind = torch.device(self.device).type
        except RuntimeError:
            kind = None
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', "
                             f"got {self.device!r}")

    def resolve_chunk(self, source: bool):
        """The engine chunk for one input type: under "auto", ``None`` (full
        batch) on resident arrays and :data:`DEFAULT_SOURCE_CHUNK` on
        sources; an explicit int as it is."""
        if self.chunk_size == "auto":
            return DEFAULT_SOURCE_CHUNK if source else None
        return self.chunk_size

    def resolve_tol(self, algorithm: str = "em") -> float:
        return TOL_DEFAULTS[algorithm] if self.tol == "auto" else self.tol

    def resolve_max_iter(self, algorithm: str = "em") -> int:
        return (MAX_ITER_DEFAULTS[algorithm] if self.max_iter == "auto"
                else self.max_iter)

    def resolve_device(self) -> torch.device:
        return resolve_device(self.device)

    @property
    def is_diagonal(self) -> bool:
        return self.covariance_type == "diag"

    def replace(self, **changes) -> "FitConfig":
        """A new validated config with the given fields replaced."""
        return dataclasses.replace(self, **changes)
