"""The fixed slot pool behind continuous batching (port of
``repro/serve/slots.py``).

The pool owns the one device-facing shape of the hot path: a ``(slots,
rows_per_slot, d)`` f32 slab and its ``(slots, rows_per_slot)`` 0/1 row
mask. Requests are admitted into free slots mid-flight, a request longer
than ``rows_per_slot`` streams through its slot across micro-batches, and
short ones are zero-padded, so the engine's scoring step always sees the
same shapes and admission, progress and retirement are host bookkeeping.

Slab and mask live in one host tensor, ``buffer`` (slab first, then mask),
pinned when the engine runs on the card, so one copy carries a micro-batch
to the device. ``slab`` and ``mask`` are numpy views of it, which the pool
stages into.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.serve.types import ScoreRequest, ScoreResult


@dataclasses.dataclass
class InFlight:
    """Host bookkeeping of one admitted request: the cursor into its rows
    and the output chunks harvested so far. ``version`` is pinned at
    admission; the swap protocol makes it the version of every model that
    touches this request."""

    request: ScoreRequest
    submitted_s: float
    version: Union[int, str]
    cursor: int = 0
    chunks: List[np.ndarray] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        """True once every row of the request has been scored."""
        return self.cursor >= self.request.num_rows


class SlotPool:
    """Fixed pool of ``slots`` request slots over one slab shape.

    The engine's protocol per micro-batch is three calls:

    1. :meth:`admit` queued requests into free slots (at any time, also
       while other slots are mid-request);
    2. :meth:`stage` each active slot's next ``<= rows_per_slot`` rows into
       the slab and mask;
    3. :meth:`harvest` the step's ``(slots, rows_per_slot[, K])`` output
       into per-request chunks, retiring finished requests.

    ``pin_memory`` pins ``buffer`` (needs CUDA).
    """

    def __init__(self, slots: int, rows_per_slot: int, dim: int,
                 pin_memory: bool = False):
        if slots < 1 or rows_per_slot < 1 or dim < 1:
            raise ValueError(
                f"slots, rows_per_slot and dim must be positive, got "
                f"({slots}, {rows_per_slot}, {dim})")
        self.slots = slots
        self.rows_per_slot = rows_per_slot
        self.dim = dim
        cells = slots * rows_per_slot
        self.buffer = torch.zeros(cells * (dim + 1), dtype=torch.float32,
                                  pin_memory=pin_memory)
        self.slab = self.buffer[:cells * dim].view(
            slots, rows_per_slot, dim).numpy()
        self.mask = self.buffer[cells * dim:].view(
            slots, rows_per_slot).numpy()
        self._entries: List[Optional[InFlight]] = [None] * slots

    # -- occupancy ------------------------------------------------------

    @property
    def in_flight(self) -> int:
        """Number of occupied slots (requests admitted, not yet retired)."""
        return sum(e is not None for e in self._entries)

    @property
    def free(self) -> int:
        """Number of slots available for admission."""
        return self.slots - self.in_flight

    @property
    def idle(self) -> bool:
        """True when no request is in flight."""
        return self.in_flight == 0

    # -- the three-call protocol ---------------------------------------

    def admit(self, entry: InFlight) -> int:
        """Bind an in-flight entry to the first free slot -> slot index.
        Raises :class:`RuntimeError` when the pool is full (the engine
        checks ``free`` first; the queue absorbs overflow)."""
        for s, occupant in enumerate(self._entries):
            if occupant is None:
                self._entries[s] = entry
                return s
        raise RuntimeError("slot pool is full; check .free before admit")

    def stage(self) -> List[int]:
        """Write each active slot's next row window into the slab and mask
        (zero-padding the tail) -> the active slot indices of this
        micro-batch. Inactive slots get mask 0; their stale slab rows are
        cancelled by the mask."""
        active = []
        for s, entry in enumerate(self._entries):
            if entry is None:
                self.mask[s] = 0.0
                continue
            rows = entry.request.rows[
                entry.cursor: entry.cursor + self.rows_per_slot]
            take = rows.shape[0]
            self.slab[s, :take] = rows
            self.slab[s, take:] = 0.0
            self.mask[s, :take] = 1.0
            self.mask[s, take:] = 0.0
            active.append(s)
        return active

    def harvest(self, out: np.ndarray,
                active: List[int]) -> List[ScoreResult]:
        """Copy the step output ``out`` (``(slots, rows_per_slot[, K])``,
        which the engine reuses) into the active requests' chunks, advance
        their cursors, and retire every request whose rows are exhausted ->
        the finished :class:`ScoreResult` list (their slots are freed)."""
        results: List[ScoreResult] = []
        now = time.time()
        for s in active:
            entry = self._entries[s]
            take = min(entry.request.num_rows - entry.cursor,
                       self.rows_per_slot)
            entry.chunks.append(np.array(out[s, :take]))
            entry.cursor += take
            if entry.done:
                scores = (np.concatenate(entry.chunks, axis=0)
                          if entry.chunks else
                          np.zeros((0,) + out.shape[2:], np.float32))
                results.append(ScoreResult(
                    rid=entry.request.rid, scores=scores,
                    model_version=entry.version,
                    latency_s=now - entry.submitted_s))
                self._entries[s] = None
        return results

    def retire_empty(self, entry: InFlight,
                     trailing: tuple = ()) -> ScoreResult:
        """Zero-row requests never occupy a slot: retire one directly with
        an empty score array of the right shape (``trailing`` is ``(K,)``
        in responsibilities mode, ``()`` otherwise)."""
        return ScoreResult(
            rid=entry.request.rid,
            scores=np.zeros((0,) + tuple(trailing), np.float32),
            model_version=entry.version,
            latency_s=time.time() - entry.submitted_s)
