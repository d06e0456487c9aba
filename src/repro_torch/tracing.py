"""Host spans of the port's fit path, recorded in memory.

Every layer boundary of a federated fit opens a span (:data:`SPAN_NAMES`):
the facade's ``api.run`` at the root, the split's upload, each round, the
one-shot pipeline's halves, the k-means init, seeding and Lloyd loops, the
EM loop, and a ``sync`` span around each host read of a device value (and
each copy that waits for the device). Nothing is recorded unless
:func:`recording` is open::

    with repro_torch.tracing.recording() as rec:
        FedGenGMM(k_clients=10, k_global=10).run(split)
    print(rec.format())

Off, a span site costs one check of a module-level reference and hands back
one shared no-op context. On, each span keeps its name, its host start and
end (``time.perf_counter_ns``), its parent, its fit (the root span's id)
and a small dict of host integers, and also opens a profiler annotation of
its name (``record_function``, in its C-level form), so a profiler that is
recording puts the spans on the timeline of the device's events. No span
synchronizes the device or reads a device value; a span's wall is host
time. Spans are recorded from the thread that opened the recording only.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from types import MappingProxyType
from typing import Optional

# the C-level form of ``record_function`` (PyTorch 2.2 on): a span costs a
# tenth of what the Python form costs
from torch._C._profiler import _RecordFunctionFast as annotation

SPAN_NAMES = ("api.run", "fed.upload", "fed.round", "fedgen.locals",
              "fedgen.server", "fedgen.sample", "kmeans.init", "kmeans.seed",
              "kmeans.lloyd", "em.loop", "sync")

# the info of a span that noted nothing: shared, so a span allocates no dict
_NO_INFO = MappingProxyType({})


class Span:
    """One recorded span: ``id`` is its index in the recording, ``parent``
    the id of the span open around it (None at a root), ``fit`` its root's
    id, ``info`` the host integers noted in it."""

    __slots__ = ("name", "id", "parent", "fit", "start_ns", "end_ns", "info",
                 "_recording", "_annotation")

    def __init__(self, name: str, recording: "Recording"):
        self.name = name
        self._recording = recording
        self.info = _NO_INFO

    @property
    def ms(self) -> float:
        """The span's host wall, in ms."""
        return (self.end_ns - self.start_ns) / 1e6

    def __enter__(self):
        rec = self._recording
        top = rec._open[-1] if rec._open else None
        self.id = len(rec.spans)
        self.parent = None if top is None else top.id
        self.fit = self.id if top is None else top.fit
        rec.spans.append(self)
        rec._open.append(self)
        self._annotation = annotation(self.name)
        self._annotation.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        self._annotation.__exit__(*exc)
        self._annotation = None
        self._recording._open.pop()
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"fit={self.fit}, {self.ms:.3f} ms, {dict(self.info)})")


class Recording:
    """The spans of one :func:`recording` block, in the order they
    opened (a parent before its children)."""

    def __init__(self):
        self.spans: list = []
        self._open: list = []
        self._thread = threading.get_ident()

    def fits(self) -> list:
        """The root ``api.run`` spans, one a facade run."""
        return [s for s in self.spans
                if s.parent is None and s.name == "api.run"]

    def within(self, span: Span, name: Optional[str] = None) -> list:
        """Every span below ``span`` (its descendants), or those of them
        named ``name``."""
        inside, out = {span.id}, []
        for s in self.spans[span.id + 1:]:
            if s.fit != span.fit:
                continue
            if s.parent in inside:
                inside.add(s.id)
                if name is None or s.name == name:
                    out.append(s)
        return out

    def format(self) -> str:
        """The tree, one line a name under each parent: how many spans of
        that name it holds, their summed wall and their noted integers
        (summed)."""
        kids: dict = {}
        for s in self.spans:
            kids.setdefault(s.parent, []).append(s)
        lines: list = []

        def walk(group: list, depth: int) -> None:
            by_name: dict = {}
            for s in group:
                by_name.setdefault(s.name, []).append(s)
            for name, same in by_name.items():
                info: dict = {}
                for s in same:
                    for k, v in s.info.items():
                        info[k] = info.get(k, 0) + v
                count = f" x{len(same)}" if len(same) > 1 else ""
                extra = "".join(f" {k}={v}" for k, v in info.items())
                lines.append(f"{'  ' * depth}{name}{count} "
                             f"{sum(s.ms for s in same):.3f} ms{extra}")
                walk([c for s in same for c in kids.get(s.id, [])],
                     depth + 1)

        walk(kids.get(None, []), 0)
        return "\n".join(lines)


class _Off:
    """The context every span site gets while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_active: Optional[Recording] = None


@contextmanager
def recording():
    """Record the spans of the calls made inside the block (on this
    thread), and yield the :class:`Recording`. Recordings do not nest."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is already open")
    rec = _active = Recording()
    try:
        yield rec
    finally:
        _active = None


def span(name: str):
    """The context of one span named ``name`` (one of
    :data:`SPAN_NAMES`): a new :class:`Span` while a recording is open on
    this thread, else the shared no-op."""
    rec = _active
    if rec is None or rec._thread != threading.get_ident():
        return _OFF
    return Span(name, rec)


def note(key: str, value: int) -> None:
    """Note a host integer on the innermost open span, if one records."""
    rec = _active
    if rec is not None and rec._open and rec._thread == threading.get_ident():
        top = rec._open[-1]
        top.info = {**top.info, key: int(value)}


def blocking(fn, *args):
    """``fn(*args)`` under a ``sync`` span: a host read of a device value
    (``bool``, ``float``, ``.item()``, ``.tolist()``) or a copy that waits
    for the device. The count of ``sync`` spans is the fit's host-sync
    count."""
    if _active is None:
        return fn(*args)
    with span("sync"):
        return fn(*args)
