"""Out-of-core data sources: row streams the training engine consumes
without ever materializing the dataset (port of ``repro/data/sources.py``).

A :class:`DataSource` knows its row count and feature dimension and can
iterate fixed-size ``(chunk_size, dim)`` blocks. Every statistic the
training pipeline reduces is additive in N, so a host loop over blocks
computes the same numbers as the resident-array paths with an O(chunk·K)
working set that does not depend on N.

Iteration is restartable: ``iter_blocks`` may be called any number of
times and yields the same rows in the same order each time. Blocks are
full ``chunk_size`` rows except the final ragged remainder, and a row's
content never depends on ``chunk_size`` (only the block boundaries do),
so fits are reproducible across chunk sizes and bit-identical across
source types holding the same rows. Sources carry no sample weights: every
row a source yields has weight 1, and ragged client shards are expressed
directly (:class:`ConcatSource`).

Blocks are torch tensors. Host-backed sources (numpy arrays, memory-mapped
``.npy`` files) yield CPU tensors; :class:`SyntheticGMMSource` and an
:class:`ArraySource` over a CUDA tensor yield tensors on their own device.
:func:`prefetch_blocks` delivers every block, zero-padded to one static
row count with a 0/1 row mask, on the engine's device: on a card the host
blocks go through pinned staging buffers and a dedicated copy stream.
Where JAX would canonicalize a 64-bit dtype to 32 bits (x64 off), the
blocks are cast explicitly, so a float64 file gives float32 blocks as in
the JAX package.

This module imports nothing of the rest of the port except
``core.config.derive_seed``; :class:`SyntheticGMMSource` duck-types the
``GMM`` (``weights`` / ``means`` / ``covs`` attributes).
"""
from __future__ import annotations

import abc
import contextlib
import os
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.config import derive_seed


def default_prefetch_depth() -> int:
    """Default lookahead of :func:`prefetch_blocks`: 0 (inline, no thread)
    unless ``REPRO_PREFETCH_DEPTH`` asks for more; call sites can pass
    ``depth=`` explicitly. The JAX package sizes it from the host's cores
    (2 above two cores). On an H100 (``chip_smoke.py`` phase 9 (d), over
    a mapped ``.npy`` file) the producer thread saves about a tenth of the
    wall at 65,536-row blocks but makes it 1.6-1.8 times longer at 8,192
    rows, where the consumer's own host work a block contends with it for
    the interpreter; so the thread is opt-in."""
    env = os.environ.get("REPRO_PREFETCH_DEPTH")
    if env is None:
        return 0
    depth = int(env)
    if depth < 0:
        raise ValueError(f"REPRO_PREFETCH_DEPTH must be >= 0, got {env!r}")
    return depth


# Default lookahead of prefetch_blocks (prepared blocks in flight ahead of
# the consumer), read at import. Module-level so tests and benchmarks can
# pin it (0 = inline loop, no thread).
PREFETCH_DEPTH = default_prefetch_depth()


def _check_chunk(chunk_size: int) -> int:
    chunk_size = int(chunk_size)
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    return chunk_size


_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32,
              torch.complex128: torch.complex64}


def _canonical(dtype) -> torch.dtype:
    """The block dtype of rows stored as ``dtype`` (numpy or torch): 64-bit
    types become their 32-bit counterparts, as JAX hands them over without
    x64."""
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype
    return _CANONICAL.get(dtype, dtype)


def _host_block(rows: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A CPU tensor of a slice of host rows: a view where the rows are
    contiguous and already of the block dtype, else one converting copy."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    return torch.from_numpy(np.ascontiguousarray(rows, dtype=np_dtype))


class DataSource(abc.ABC):
    """Protocol for out-of-core row streams: ``num_rows``, ``dim``,
    ``iter_blocks(chunk_size)`` (restartable, see the module docstring)."""

    @property
    @abc.abstractmethod
    def num_rows(self) -> int:
        """Total number of rows the source yields per pass."""

    @property
    @abc.abstractmethod
    def dim(self) -> int:
        """Feature dimension of every yielded block."""

    @property
    def dtype(self) -> torch.dtype:
        """Dtype of the yielded blocks."""
        return torch.float32

    @property
    def device(self) -> torch.device:
        """Where the yielded blocks live (the CPU for host-backed rows)."""
        return torch.device("cpu")

    @abc.abstractmethod
    def iter_blocks(self, chunk_size: int) -> Iterator[torch.Tensor]:
        """Yield ``(b, dim)`` blocks with ``b == chunk_size`` everywhere but
        the final ragged block. Must be restartable and deterministic."""

    # ------------------------------------------------------------------
    def num_blocks(self, chunk_size: int) -> int:
        return -(-self.num_rows // _check_chunk(chunk_size))

    def materialize(self, chunk_size: int = 65536) -> torch.Tensor:
        """All blocks as one resident ``(num_rows, dim)`` tensor: O(N)
        memory by definition; for tests and small sources."""
        return torch.cat(list(self.iter_blocks(chunk_size)), dim=0)

    def __len__(self) -> int:
        return self.num_rows

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(num_rows={self.num_rows}, "
                f"dim={self.dim}, dtype={self.dtype})")


# ----------------------------------------------------------------------
# The block loader: pad-and-mask, and prefetch through pinned buffers
# ----------------------------------------------------------------------

def pad_target(num_rows: int, chunk_size: int) -> int:
    """The one row count every block of a ``(num_rows, chunk_size)`` stream
    is padded to: the full ``chunk_size`` for a multi-block stream (its
    ragged tail included), a multiple of 64 for a single-block stream, so
    clients of slightly different sizes share shapes."""
    chunk_size = _check_chunk(chunk_size)
    if num_rows > chunk_size:
        return chunk_size
    return min(chunk_size, -(-num_rows // 64) * 64)


_MASK_CACHE: dict = {}


def _block_mask(target: int, valid: int, dtype,
                device: torch.device) -> torch.Tensor:
    """(target,) 0/1 row mask with ``valid`` leading ones, cached per
    device, so every full block of a pass shares one buffer. Built on the
    calling thread's current stream."""
    key = (target, valid, dtype, device)
    mask = _MASK_CACHE.get(key)
    if mask is None:
        mask = torch.zeros(target, dtype=dtype, device=device)
        mask[:valid] = 1
        _MASK_CACHE[key] = mask
    return mask


def _pad_rows(xb: torch.Tensor, target: int) -> torch.Tensor:
    """``xb`` with zero rows appended up to ``target`` rows, on its device
    (``xb`` itself when it is already ``target`` rows)."""
    b = xb.shape[0]
    if b == target:
        return xb
    out = xb.new_zeros((target,) + tuple(xb.shape[1:]))
    out[:b] = xb
    return out


class _PinnedRing:
    """``slots`` pinned host buffers of one padded block each, with the
    event of each buffer's last host-to-device copy. A buffer is refilled
    only once that copy has completed."""

    def __init__(self, slots: int, shape: tuple, dtype):
        self._bufs = [torch.empty(shape, dtype=dtype, pin_memory=True)
                      for _ in range(slots)]
        self._events: list = [None] * slots
        self._next = 0

    def stage(self, xb: torch.Tensor) -> tuple[int, torch.Tensor]:
        """Copy ``xb`` into the next free buffer, zero-padded: (slot, the
        buffer)."""
        slot = self._next
        self._next = (slot + 1) % len(self._bufs)
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        buf = self._bufs[slot]
        b = xb.shape[0]
        buf[:b].copy_(xb)
        if b < buf.shape[0]:
            buf[b:].zero_()
        return slot, buf

    def copied(self, slot: int, event) -> None:
        self._events[slot] = event


_DONE = object()


def prefetch_blocks(source: DataSource, chunk_size: int,
                    depth: Optional[int] = None, device="cuda"
                    ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """Iterate ``(block, mask)`` pairs of a source on ``device``, with the
    next blocks prepared ahead of the consumer: the loader every engine
    block loop drives.

    - **pad-and-mask**: every block has the same row count
      (:func:`pad_target`), zero-padded, with a cached 0/1 row mask
      marking real rows. Padded rows carry weight 0 through every engine
      statistic and add exact zeros.
    - **prefetch**: with ``depth > 0`` a producer thread stays up to
      ``depth`` blocks ahead, so the host work of block i+1 (paging an
      mmap, generation, padding, the copy) overlaps compute on block i.
      On a card the producer sets the device, stages each host block once
      into a ring of ``depth + 1`` pinned buffers, issues the
      host-to-device copy with ``non_blocking=True`` on its own copy
      stream and records an event, which the consumer's stream waits on;
      a buffer is refilled only after its copy's event has completed, and
      every block is kept alive across the streams with
      ``Tensor.record_stream``. ``depth`` defaults to
      :data:`PREFETCH_DEPTH`; ``depth=0``, a one-block stream and a source
      whose blocks are already on a card (a synthetic stream, an array
      there) prepare inline: no thread, no copy stream, pageable copies
      (a producer's generation launches would only contend with the
      consumer's for the interpreter).

    Block order never changes, so accumulation order, and with it the
    bit-identity of source-backed fits, does not depend on ``depth``. An
    exception in the producer is raised in the consumer; the producer
    stops when the consumer drops the generator.
    """
    chunk_size = _check_chunk(chunk_size)
    if depth is None:
        depth = PREFETCH_DEPTH
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    target = pad_target(source.num_rows, chunk_size)
    dtype = source.dtype

    def inline(xb: torch.Tensor) -> torch.Tensor:
        return _pad_rows(xb.to(device), target)

    on_card = device.type == "cuda"
    if (depth <= 0 or source.num_rows <= chunk_size
            or (on_card and source.device.type != "cpu")):
        # inline: a one-block stream has nothing to overlap, and a stream
        # already on a card has no host copy to overlap; its blocks are
        # kernel launches, which a second Python thread only slows down
        for xb in source.iter_blocks(chunk_size):
            yield inline(xb), _block_mask(target, xb.shape[0], dtype, device)
        return

    q: queue.Queue = queue.Queue(maxsize=int(depth))
    stop = threading.Event()
    copy_stream = torch.cuda.Stream(device) if on_card else None
    ring = (_PinnedRing(int(depth) + 1, (target, source.dim), dtype)
            if on_card else None)

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def prepare(xb: torch.Tensor):
        """(block on the device, its rows, event or None); on a card this
        runs on the copy stream."""
        b = xb.shape[0]
        if not on_card:
            return inline(xb), b, None
        slot, buf = ring.stage(xb)
        block = buf.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(copy_stream)
        ring.copied(slot, event)
        return block, b, event

    def producer():
        try:
            if on_card:
                torch.cuda.set_device(device)
            with (torch.cuda.stream(copy_stream) if on_card
                  else contextlib.nullcontext()):
                for xb in source.iter_blocks(chunk_size):
                    if not put((None, prepare(xb))):
                        return
            put((_DONE, None))
        except BaseException as exc:  # noqa: BLE001 — raised in the consumer
            put((exc, None))

    compute = torch.cuda.current_stream(device) if on_card else None
    if on_card:
        # the copy stream starts after all the consumer has queued, so it
        # never writes memory still in use there
        copy_stream.wait_stream(compute)
    thread = threading.Thread(target=producer, daemon=True,
                              name="prefetch_blocks")
    thread.start()
    try:
        while True:
            tag, item = q.get()
            if tag is _DONE:
                return
            if tag is not None:
                raise tag
            block, b, event = item
            if event is not None:
                compute.wait_event(event)
                block.record_stream(compute)
            yield block, _block_mask(target, b, dtype, device)
    finally:
        stop.set()


# ----------------------------------------------------------------------
# Sources
# ----------------------------------------------------------------------

class ArraySource(DataSource):
    """A resident array viewed as a source: a numpy array (CPU blocks) or a
    torch tensor (blocks on its device). The parity oracle of every other
    source."""

    def __init__(self, x):
        if x.ndim != 2:
            raise ValueError(
                f"ArraySource expects (N, d) rows, got {tuple(x.shape)}")
        if x.shape[0] == 0:
            raise ValueError("ArraySource needs at least one row")
        self._x = x
        self._dtype = _canonical(x.dtype)

    @property
    def num_rows(self) -> int:
        return int(self._x.shape[0])

    @property
    def dim(self) -> int:
        return int(self._x.shape[1])

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def device(self) -> torch.device:
        if isinstance(self._x, torch.Tensor):
            return self._x.device
        return torch.device("cpu")

    def iter_blocks(self, chunk_size: int) -> Iterator[torch.Tensor]:
        chunk_size = _check_chunk(chunk_size)
        for start in range(0, self.num_rows, chunk_size):
            rows = self._x[start:start + chunk_size]
            if isinstance(rows, torch.Tensor):
                yield rows.to(self._dtype)
            else:
                yield _host_block(rows, self._dtype)


class NpyFileSource(DataSource):
    """Memory-mapped ``.npy`` rows: only the active block is ever read; the
    OS page cache owns the rest. The map is copy-on-write, so a block is a
    view of the mapped pages and writing to it never reaches the file."""

    def __init__(self, path):
        self._path = str(path)
        self._mm = np.load(self._path, mmap_mode="c")
        if self._mm.ndim != 2:
            raise ValueError(
                f"NpyFileSource expects a 2-D (N, d) array file, "
                f"got shape {self._mm.shape} in {self._path}")
        if self._mm.shape[0] == 0:
            raise ValueError(f"empty .npy source: {self._path}")
        self._dtype = _canonical(self._mm.dtype)

    @property
    def num_rows(self) -> int:
        return int(self._mm.shape[0])

    @property
    def dim(self) -> int:
        return int(self._mm.shape[1])

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    def iter_blocks(self, chunk_size: int) -> Iterator[torch.Tensor]:
        chunk_size = _check_chunk(chunk_size)
        for start in range(0, self.num_rows, chunk_size):
            yield _host_block(self._mm[start:start + chunk_size],
                              self._dtype)


class ConcatSource(DataSource):
    """Row-wise concatenation of sources (ragged federated shards).

    Blocks are re-chunked across child boundaries (on the children's
    device, so host shards are joined on the host before the one copy of
    each block), and the emitted partition, and with it every engine
    reduction bit for bit, is that of an :class:`ArraySource` over the
    concatenated rows, however unevenly the children split them.
    """

    def __init__(self, sources: Sequence[DataSource]):
        sources = list(sources)
        if not sources:
            raise ValueError("ConcatSource needs at least one child source")
        dims = {s.dim for s in sources}
        if len(dims) != 1:
            raise ValueError(f"child sources disagree on dim: {sorted(dims)}")
        dtypes = {s.dtype for s in sources}
        if len(dtypes) != 1:
            # a block's dtype would depend on which children it straddles,
            # i.e. on the chunk partition
            raise ValueError("child sources disagree on dtype: "
                             f"{sorted(str(d) for d in dtypes)}")
        devices = {s.device for s in sources}
        if len(devices) != 1:
            raise ValueError("child sources disagree on device: "
                             f"{sorted(str(d) for d in devices)}")
        self._sources = sources
        self._num_rows = sum(s.num_rows for s in sources)
        self._dim = sources[0].dim

    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def dtype(self) -> torch.dtype:
        return self._sources[0].dtype

    @property
    def device(self) -> torch.device:
        return self._sources[0].device

    def iter_blocks(self, chunk_size: int) -> Iterator[torch.Tensor]:
        chunk_size = _check_chunk(chunk_size)
        pending: list[torch.Tensor] = []
        have = 0
        for src in self._sources:
            for block in src.iter_blocks(chunk_size):
                pending.append(block)
                have += block.shape[0]
                while have >= chunk_size:
                    buf = (pending[0] if len(pending) == 1
                           else torch.cat(pending, dim=0))
                    yield buf[:chunk_size]
                    rest = buf[chunk_size:]
                    pending = [rest] if rest.shape[0] else []
                    have = rest.shape[0]
        if have:
            yield (pending[0] if len(pending) == 1
                   else torch.cat(pending, dim=0))


# Generation granule of the seeded streams (the mixture rows here, the
# Gumbel noise of streamed k-means++ in core/kmeans.py): tile t owns the
# global rows [t*TILE, (t+1)*TILE) and is drawn in full from its own
# seed, so a row never depends on chunk_size (a block boundary may fall
# mid-tile) and a tile's draw is the same launch every time. At the
# default 65,536-row chunk a block is one tile: two RNG launches a
# synthetic block; at most one tile of rows is drawn in vain a block.
TILE = 65536


def tiled(start: int, size: int, draw, axis: int = 0) -> list:
    """Rows [start, start + size) of a tiled stream: ``draw(t)`` gives tile
    t's tensors (the tile's rows on ``axis``); the covering tiles are drawn
    and each tensor is cut to the rows asked for."""
    first, last = start // TILE, (start + size - 1) // TILE
    parts = [draw(t) for t in range(first, last + 1)]
    off = start - first * TILE
    return [(p[0] if len(p) == 1 else torch.cat(p, dim=axis))
            .narrow(axis, off, size) for p in zip(*parts)]


class SyntheticGMMSource(DataSource):
    """Samples from a GMM, generated block by block from a seed: the
    server-side synthetic replay set of FedGenGMM (|S| = H · Σ K_c) without
    materializing it up front. Re-iteration yields identical rows, from a
    bounded block cache on the device when the source fits ``cache_rows``,
    regenerated from the same seeds otherwise, so a multi-pass EM fit sees
    one fixed virtual dataset either way.

    ``gmm`` is any object with ``weights (K,)``, ``means (K, d)`` and
    ``covs`` (``(K, d)`` diagonal variances or ``(K, d, d)`` full)
    attributes, tensors or arrays. Rows are generated on ``device``: by
    default the device of ``gmm.means`` when it is a tensor, else CUDA.
    """

    def __init__(self, gmm, num_rows: int, seed: int,
                 cache_rows: int = 1 << 17, device=None):
        num_rows = int(num_rows)
        if num_rows <= 0:
            raise ValueError(f"num_rows must be positive, got {num_rows}")
        if device is None:
            device = (gmm.means.device if isinstance(gmm.means, torch.Tensor)
                      else "cuda")
        device = torch.device(device)
        means = torch.as_tensor(gmm.means, device=device)
        dtype = _canonical(means.dtype)
        means = means.to(dtype)
        covs = torch.as_tensor(gmm.covs, device=device).to(dtype)
        weights = torch.as_tensor(gmm.weights, device=device).to(dtype)
        self._cum_weights = torch.cumsum(weights / weights.sum(), dim=0)
        self._means = means
        self._scale = (torch.sqrt(covs) if covs.ndim == 2
                       else torch.linalg.cholesky(covs))
        self._seed = int(seed)
        self._num_rows = num_rows
        self._tile_seeds: dict = {}   # tile -> derive_seed(seed, "tile", t)
        # Generation costs device time on every pass of a multi-pass fit
        # while the rows never change. A source within ``cache_rows`` keeps
        # its generated blocks on the device after the first pass (the
        # FedGen replay sets are tens of thousands of rows); a larger one
        # regenerates every pass, so its working set stays O(chunk).
        # ``cache_rows=0`` disables the cache.
        self._cache_rows = int(cache_rows)
        self._cache: dict[int, list] = {}

    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def dim(self) -> int:
        return int(self._means.shape[1])

    @property
    def dtype(self) -> torch.dtype:
        return self._means.dtype

    @property
    def device(self) -> torch.device:
        return self._means.device

    def iter_blocks(self, chunk_size: int) -> Iterator[torch.Tensor]:
        chunk_size = _check_chunk(chunk_size)
        gen = torch.Generator(device=self.device)
        if self._num_rows <= self._cache_rows:
            blocks = self._cache.get(chunk_size)
            if blocks is None:
                blocks = [self._gen_block(gen, start, chunk_size)
                          for start in range(0, self._num_rows, chunk_size)]
                self._cache[chunk_size] = blocks
            yield from blocks
            return
        for start in range(0, self._num_rows, chunk_size):
            yield self._gen_block(gen, start, chunk_size)

    def _gen_block(self, gen: torch.Generator, start: int,
                   chunk_size: int) -> torch.Tensor:
        """Rows [start, start + size) of the stream: the covering tiles,
        each drawn in full from ``derive_seed(seed, "tile", t)`` (TILE
        uniforms for the components, through the mixture's CDF, and a
        (TILE, d) normal block), then the block cut out."""
        size = min(chunk_size, self._num_rows - start)
        dev, d, dtype = self.device, self.dim, self.dtype

        def draw(t):
            s = self._tile_seeds.get(t)
            if s is None:
                s = self._tile_seeds[t] = derive_seed(self._seed, "tile", t)
            gen.manual_seed(s)
            return (torch.rand(TILE, generator=gen, device=dev, dtype=dtype),
                    torch.randn((TILE, d), generator=gen, device=dev,
                                dtype=dtype))

        u, eps = tiled(start, size, draw)
        # P(comp = j) is the j-th weight; the clamp catches a rounded CDF
        # that ends a hair below 1
        comp = torch.clamp(torch.searchsorted(self._cum_weights, u,
                                              right=True),
                           max=self._means.shape[0] - 1)
        mu = torch.index_select(self._means, 0, comp)
        scale = torch.index_select(self._scale, 0, comp)
        if scale.ndim == 2:  # diagonal: standard deviations
            return mu + scale * eps
        return mu + (scale @ eps.unsqueeze(-1)).squeeze(-1)


class ShuffledSource(DataSource):
    """Windowed multi-epoch reshuffle of another source.

    ``epoch=0`` is an exact passthrough (same blocks, same order, bit for
    bit). For ``epoch >= 1`` rows are permuted inside windows of
    ``window_blocks`` consecutive blocks (an O(window · chunk) buffer,
    never O(N)) by a permutation drawn on the host from
    ``derive_seed(seed, epoch, window)``: deterministic, restartable, the
    same on every device, and different every epoch. ``with_epoch(e)``
    derives another epoch's view of the same inner source.
    """

    def __init__(self, inner: DataSource, seed: int, epoch: int = 0,
                 window_blocks: int = 8):
        self._inner = inner
        self._seed = int(seed)
        self._epoch = int(epoch)
        if self._epoch < 0:
            raise ValueError(f"epoch must be >= 0, got {epoch}")
        self._window_blocks = int(window_blocks)
        if self._window_blocks <= 0:
            raise ValueError(
                f"window_blocks must be positive, got {window_blocks}")

    @property
    def num_rows(self) -> int:
        return self._inner.num_rows

    @property
    def dim(self) -> int:
        return self._inner.dim

    @property
    def dtype(self) -> torch.dtype:
        return self._inner.dtype

    @property
    def device(self) -> torch.device:
        return self._inner.device

    @property
    def epoch(self) -> int:
        return self._epoch

    def with_epoch(self, epoch: int) -> "ShuffledSource":
        return ShuffledSource(self._inner, self._seed, epoch,
                              self._window_blocks)

    def iter_blocks(self, chunk_size: int) -> Iterator[torch.Tensor]:
        chunk_size = _check_chunk(chunk_size)
        if self._epoch == 0:
            yield from self._inner.iter_blocks(chunk_size)
            return
        window: list[torch.Tensor] = []
        widx = 0

        def flush(window, widx):
            buf = window[0] if len(window) == 1 else torch.cat(window, dim=0)
            gen = torch.Generator().manual_seed(
                derive_seed(self._seed, self._epoch, widx))
            perm = torch.randperm(buf.shape[0], generator=gen)
            buf = buf[perm.to(buf.device)]
            for s in range(0, buf.shape[0], chunk_size):
                yield buf[s:s + chunk_size]

        for block in self._inner.iter_blocks(chunk_size):
            window.append(block)
            if len(window) == self._window_blocks:
                yield from flush(window, widx)
                window, widx = [], widx + 1
        if window:
            yield from flush(window, widx)


def as_source(x) -> DataSource:
    """An ``(N, d)`` array or tensor as an :class:`ArraySource`; sources
    pass through unchanged."""
    if isinstance(x, DataSource):
        return x
    return ArraySource(x)
