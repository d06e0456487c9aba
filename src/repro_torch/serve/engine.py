"""The continuous-batching GMM scoring engine (port of
``repro/serve/engine.py``).

One queue, one fixed :class:`~repro_torch.serve.slots.SlotPool`, one
scoring step over the whole slab::

    submit -> [queue] -> admit into free slots -> score the slab
                 ^            (mid-flight)        (one fixed shape)
                 |                                       |
                 +------ retire finished requests <------+

Each :meth:`ScoringEngine.step` is one micro-batch: poll the attached model
store, finish a pending hot swap if the pool has drained, admit queued
requests into free slots, score the ``(slots, rows_per_slot, d)`` slab,
and harvest and retire. Requests longer than ``rows_per_slot`` stream
through their slot across micro-batches; short ones are padded.

**The step on the card.** At each install the model is packed once into
the log-density kernels' operands (``ops.pack_params``, as ``api.log_prob``
packs it, so scores keep their bits). On the ``fused`` backend the step's
device work is then captured as one CUDA graph: the ``gmm_log_prob`` kernel
over ``slots * rows_per_slot`` rows (``log_prob``, ``anomaly``) or the
per-component ``gmm_logpdf`` kernel and a softmax over components
(``responsibilities``), the row mask and, for ``anomaly``, the negation. A
micro-batch is one copy of the pinned slab and mask to the device, one
replay, and one copy of the output into pinned host memory. The copies stay
outside the graph, which holds only device memory: the slab's device copy,
the packed model and the output. A capture that fails raises; nothing
retries eagerly or on the CPU. The ``reference`` backend (full covariance,
or asked for by name) runs the step eagerly. On the CPU no graph is
captured, and the ``fused`` backend runs the kernels' plain versions
through the same packing.

The launch wrappers count where they are called: once for the warm-up
before a capture and once for the capture that records the launch. A
replay does not call them; :attr:`ScoringEngine.replays` counts replays
and :data:`captures` the graphs captured.

**Hot model swap** (drain-and-install): :meth:`install` (or a newer version
in the attached store) marks the new model *pending*: admission stops,
in-flight requests finish under the old model, and the instant the pool
drains the new model is installed (packed and captured) and admission
resumes. Every request is scored by exactly ONE model version, the one its
result carries; no request is dropped; the version tag flips at exactly one
admission boundary. The admission pause of each swap is kept in
:attr:`ScoringEngine.swap_pauses`.
"""
from __future__ import annotations

import time
from collections import deque
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.core.config import resolve_backend, resolve_device
from repro_torch.core.gmm import GMM
from repro_torch.kernels import gmm_logpdf, ops
from repro_torch.serve.slots import InFlight, SlotPool
from repro_torch.serve.types import ScoreConfig, ScoreRequest, ScoreResult

#: CUDA graphs captured by all engines (one at each install of a model on
#: the fused backend on the card).
captures = 0


class ScoringEngine:
    """Serve one global GMM to a stream of scoring requests.

    - ``gmm``: the model to serve (diagonal or full covariance: ``weights
      (K,)``, ``means (K, d)``, ``covs (K, d)|(K, d, d)``); it is moved to
      the config's device.
    - ``config``: a :class:`~repro_torch.serve.types.ScoreConfig` (mode,
      slot pool geometry, backend, store poll cadence, device).
    - ``version``: tag echoed in every result scored by this model.
    - ``store``: optional subscription, any object whose ``poll()`` returns
      an object with ``.version`` and ``.gmm`` for a newly published model,
      or None (:class:`repro_torch.serve.ModelStore`). Polled every
      ``config.poll_every`` micro-batches; a new version starts the
      drain-and-install swap.

    Streaming use is ``submit`` and repeated ``step``; ``run(requests)``
    submits all, drains and returns every result, in retirement order
    (``rid`` maps them back).
    """

    def __init__(self, gmm: GMM, config: Optional[ScoreConfig] = None, *,
                 version: Union[int, str] = "v0", store=None):
        self.config = config if config is not None else ScoreConfig()
        if not isinstance(self.config, ScoreConfig):
            raise TypeError(f"config must be a ScoreConfig, "
                            f"got {type(self.config).__name__}")
        self.device = resolve_device(self.config.device)
        on_card = self.device.type == "cuda"
        self._store = store
        self._queue: deque = deque()
        self._pending: Optional[tuple] = None     # (gmm, version)
        self._pending_since: Optional[float] = None
        self.steps = 0
        self.swaps = 0
        self.completed = 0
        #: micro-batches run by replaying the captured graph
        self.replays = 0
        #: seconds each completed swap stalled admission (drain time)
        self.swap_pauses: List[float] = []
        #: seconds each graph capture took (warm-up included)
        self.capture_s: List[float] = []
        self._pool = SlotPool(self.config.slots, self.config.rows_per_slot,
                              int(gmm.n_features), pin_memory=on_card)
        # the slab and mask the step reads: a device copy of the pool's
        # buffer on the card, the pool's own buffer on the CPU
        inputs = (self._pool.buffer.to(self.device) if on_card
                  else self._pool.buffer)
        cells = self.config.slots * self.config.rows_per_slot
        self._inputs = inputs
        self._x = inputs[:cells * self.dim].view(cells, self.dim)
        self._mask = inputs[cells * self.dim:].view(
            self.config.slots, self.config.rows_per_slot)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[torch.Tensor] = None
        self._host_out: Optional[torch.Tensor] = None
        self._set_model(gmm, version)

    # -- model ----------------------------------------------------------

    @property
    def version(self) -> Union[int, str]:
        """Version tag of the installed model (new admissions are scored,
        and tagged, with it)."""
        return self._version

    @property
    def gmm(self) -> GMM:
        """The installed model, on the engine's device."""
        return self._gmm

    @property
    def dim(self) -> int:
        """Feature dimension every request's rows must match."""
        return self._pool.dim

    @property
    def backend(self) -> str:
        """The resolved backend of the installed model."""
        return self._backend

    @property
    def graph(self) -> Optional[torch.cuda.CUDAGraph]:
        """The captured micro-batch of the installed model, or None where
        the step runs eagerly (the CPU, the reference backend)."""
        return self._graph

    @property
    def swap_pending(self) -> bool:
        """True while a newer model waits for in-flight requests to drain
        (admission is stalled)."""
        return self._pending is not None

    def _set_model(self, gmm: GMM, version: Union[int, str]) -> None:
        if not isinstance(gmm, GMM):
            raise TypeError(f"engine serves a repro_torch.core.gmm.GMM, "
                            f"got {type(gmm).__name__}")
        if int(gmm.n_features) != self.dim:
            raise ValueError(
                f"model dim {int(gmm.n_features)} != engine dim "
                f"{self.dim}; a swap cannot change the feature dimension")
        # "auto" resolves per model: the kernels serve diagonal covariance
        # only (as in training).
        backend = resolve_backend(self.config.backend, self.device,
                                  gmm.is_diagonal)
        self._graph = self._out = None
        self._gmm = gmm.to(self.device)
        self._version = version
        self._backend = backend
        self._packed = (ops.pack_params(self._gmm.means, self._gmm.covs,
                                        torch.log(self._gmm.weights))
                        if backend == "fused" else None)
        if backend == "fused" and self.device.type == "cuda":
            self._capture()

    def _score(self) -> torch.Tensor:
        """The step's device work on the slab and mask: ``(S, R)`` scores
        (log_prob, anomaly) or ``(S, R, K)`` responsibilities. Padding rows
        are multiplied by 0 AFTER the per-row computation, and ``x * 1.0``
        is exact, so a valid row keeps the bits of its log density."""
        s, r = self._mask.shape
        if self.config.mode == "responsibilities":
            if self._backend == "fused":
                lp = gmm_logpdf.gmm_logpdf(self._x, *self._packed)
                resp = torch.softmax(lp, dim=1)
            else:
                resp = self._gmm.responsibilities(self._x)
            return resp.view(s, r, -1) * self._mask[:, :, None]
        if self._backend == "fused":
            lp = gmm_logpdf.gmm_log_prob(self._x, *self._packed)
        else:
            lp = self._gmm.log_prob(self._x)
        lp = lp.view(s, r) * self._mask
        return lp if self.config.mode == "log_prob" else -lp

    def _capture(self) -> None:
        """Capture :meth:`_score` as the installed model's CUDA graph, after
        one warm-up call on a side stream (it loads the kernel library and
        sets the kernel's shared-memory limit, neither of which a capture
        may do first).

        The capture is thread-local: a trainer thread that keeps fitting on
        the card while a new round is installed (allocating, syncing,
        launching on its own stream) must not invalidate it. Under the
        default "global" mode such a call from another thread breaks the
        capture (``cudaErrorStreamCaptureInvalidated``); the captured work
        is this thread's capture stream alone either way."""
        global captures
        t0 = time.perf_counter()
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self._score()
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self._score()
        self._graph, self._out = graph, out
        captures += 1
        self.capture_s.append(time.perf_counter() - t0)

    def _run_slab(self) -> np.ndarray:
        """Score the staged slab -> the host output (reused each step)."""
        if self.device.type == "cpu":
            return self._score().numpy()
        self._inputs.copy_(self._pool.buffer, non_blocking=True)
        if self._graph is not None:
            self._graph.replay()
            self.replays += 1
            out = self._out
        else:
            out = self._score()
        if self._host_out is None or self._host_out.shape != out.shape:
            self._host_out = torch.empty(out.shape, dtype=out.dtype,
                                         pin_memory=True)
        self._host_out.copy_(out, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self._host_out.numpy()

    def install(self, gmm: GMM, version: Union[int, str]) -> None:
        """Hot-swap to a new model. Installs at once when no request is in
        flight; otherwise the swap goes *pending*: admission stops,
        in-flight requests finish under the old model, and the install
        lands the moment the pool drains. A second install while pending
        replaces the pending model (latest wins) but keeps the original
        stall clock."""
        if self._pool.idle:
            self._set_model(gmm, version)
            self.swaps += 1
            return
        if self._pending_since is None:
            self._pending_since = time.time()
        self._pending = (gmm, version)

    def _finish_swap_if_drained(self) -> None:
        if self._pending is not None and self._pool.idle:
            gmm, version = self._pending
            self._pending = None
            if self._pending_since is not None:
                self.swap_pauses.append(time.time() - self._pending_since)
                self._pending_since = None
            self._set_model(gmm, version)
            self.swaps += 1

    def _poll_store(self) -> None:
        if self._store is None or self.steps % self.config.poll_every:
            return
        published = self._store.poll()
        if published is not None:
            self.install(published.gmm, published.version)

    @classmethod
    def from_store(cls, store, config: Optional[ScoreConfig] = None,
                   *, follow: bool = True) -> "ScoringEngine":
        """An engine serving the latest model published in ``store`` (a
        :class:`repro_torch.serve.ModelStore`). ``follow=True`` keeps the
        subscription, so later publishes hot-swap in; ``follow=False`` pins
        the latest version. Raises :class:`FileNotFoundError` when nothing
        has been published."""
        published = store.latest()
        if published is None:
            raise FileNotFoundError(
                f"model store {store.root!r} has no published model yet")
        return cls(published.gmm, config, version=published.version,
                   store=store if follow else None)

    # -- the request stream --------------------------------------------

    @property
    def queued(self) -> int:
        """Requests submitted but not yet admitted to a slot."""
        return len(self._queue)

    @property
    def in_flight(self) -> int:
        """Requests occupying slots (admitted, not retired)."""
        return self._pool.in_flight

    @property
    def pending_requests(self) -> int:
        """Requests the engine still owes results for (queued plus in
        flight); ``drain`` loops until this reaches zero."""
        return self.queued + self.in_flight

    def submit(self, request: ScoreRequest) -> None:
        """Enqueue one request (FIFO). The feature dimension is checked
        here, so a malformed request fails at the submit site."""
        if not isinstance(request, ScoreRequest):
            raise TypeError(f"submit takes a ScoreRequest, "
                            f"got {type(request).__name__}")
        if request.rows.shape[1] != self.dim:
            raise ValueError(
                f"request {request.rid}: rows have dim "
                f"{request.rows.shape[1]}, the served model expects "
                f"{self.dim}")
        self._queue.append(request)

    def _admit(self, results: List[ScoreResult]) -> None:
        """Fill free slots from the queue (FIFO). Blocked while a swap is
        pending (the drain half of the protocol). Zero-row requests retire
        at once; they still take an admission, so their version tag
        honours the swap boundary."""
        if self._pending is not None:
            return
        while self._queue:
            head = self._queue[0]
            if head.num_rows == 0:
                self._queue.popleft()
                entry = InFlight(head, time.time(), self._version)
                trailing = ((int(self._gmm.n_components),)
                            if self.config.mode == "responsibilities"
                            else ())
                results.append(self._pool.retire_empty(entry, trailing))
                self.completed += 1
                continue
            if self._pool.free == 0:
                return
            self._pool.admit(InFlight(head, time.time(), self._version))
            self._queue.popleft()

    # -- micro-batches --------------------------------------------------

    def step(self) -> List[ScoreResult]:
        """Run ONE micro-batch -> the requests that finished in it.

        Poll the store, finish a drained swap, admit into free slots, score
        the slab, harvest and retire, and finish the swap again if those
        retirements drained the pool. An idle step returns ``[]``."""
        self.steps += 1
        self._poll_store()
        self._finish_swap_if_drained()
        results: List[ScoreResult] = []
        self._admit(results)
        active = self._pool.stage()
        if active:
            finished = self._pool.harvest(self._run_slab(), active)
            self.completed += len(finished)
            results.extend(finished)
        self._finish_swap_if_drained()
        return results

    def drain(self) -> List[ScoreResult]:
        """Step until every submitted request has retired -> all results
        (retirement order). A pending swap cannot stall this: once the pool
        drains it installs and admission resumes."""
        results: List[ScoreResult] = []
        while self.pending_requests:
            results.extend(self.step())
        return results

    def run(self, requests) -> List[ScoreResult]:
        """Submit every request, drain, and return all results (retirement
        order; match them back by ``rid``)."""
        for request in requests:
            self.submit(request)
        return self.drain()
