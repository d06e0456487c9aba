"""The span recorder of the port (``repro_torch.tracing``) on the fit path
of the benchmark's two cells: one-shot FedGenGMM and DEM.

The CPU cases hold the tree of one fit (one ``api.run`` root whose id
every span carries, the layers of the span table beneath it, each
``em.loop``'s ``iters`` equal to its fit's ``n_iter``), and hold that the
recorder, off, records nothing and, on, leaves the results bit for bit,
and that each span is a C-level profiler event, seen as often as held.
The ``cuda`` cases skip without a card; the file imports no JAX, so on a
card they run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_tracing.py

and hold that every synchronizing call PyTorch's sync debug mode reports
falls in a ``sync`` span or in ``fed.upload``, that the recorder adds none,
and that a profiler of the card sees each span as often as the recording
holds it.
"""
import threading
import warnings
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.api import DEM, FedGenGMM
from repro_torch.core import fedgen
from repro_torch.core.config import FitConfig
from repro_torch.core.partition import ClientSplit

PATHS = ("fedgen", "dem")


def make_split(rng, clients: int, rows: int, d: int = 6,
               k: int = 3) -> ClientSplit:
    """A padded split of ``clients`` of about ``rows`` rows each, drawn from
    one planted mixture; the last client is short, so padding exists."""
    mus = rng.normal(0.0, 4.0, (k, d))
    sizes = np.full(clients, rows, np.int64)
    sizes[-1] = rows - rows // 5
    data = np.zeros((clients, rows, d), np.float32)
    mask = np.zeros((clients, rows), np.float32)
    for c, n in enumerate(sizes):
        y = rng.integers(0, k, n)
        data[c, :n] = mus[y] + rng.normal(0.0, 0.6, (n, d))
        mask[c, :n] = 1.0
    return ClientSplit(data, mask, sizes, np.zeros((clients, 1), np.int64))


def make_runner(path: str, device: str, h: int = 20):
    cfg = FitConfig(device=device, max_iter=40)
    if path == "fedgen":
        return FedGenGMM(k_clients=3, k_global=3, h=h, config=cfg)
    return DEM(3, config=cfg)


@pytest.fixture
def small_split(rng):
    return make_split(rng, clients=4, rows=600)


def run_recorded(path, split, device="cpu", h=20, seed=3):
    """(result, recording, refits) of one run with the recorder on; a
    one-shot run's refit ``EMResult`` is kept from ``aggregate_cfg``
    (``FedGenResult`` drops its ``n_iter``)."""
    refits = []
    aggregate = fedgen.aggregate_cfg

    def kept(*args, **kwargs):
        out = aggregate(*args, **kwargs)
        refits.append(out[0])
        return out

    fedgen.aggregate_cfg = kept
    try:
        with tracing.recording() as rec:
            res = make_runner(path, device, h).run(split, seed=seed)
    finally:
        fedgen.aggregate_cfg = aggregate
    return res, rec, refits


@pytest.mark.parametrize("path", PATHS)
def test_one_root_per_run_and_one_fit_id(path, small_split):
    _, rec, _ = run_recorded(path, small_split)
    (root,) = rec.fits()
    assert root.parent is None and root.id == 0
    assert all(s.fit == root.id for s in rec.spans)
    assert {s.name for s in rec.spans} <= set(tracing.SPAN_NAMES)
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans[1:]:
        p = by_id[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, s
    assert rec.within(root) == rec.spans[1:]
    assert not rec._open


def _children(rec, span, name):
    return [s for s in rec.spans if s.parent == span.id and s.name == name]


@pytest.mark.parametrize("path", PATHS)
def test_the_tree_is_the_span_table(path, small_split):
    res, rec, refits = run_recorded(path, small_split)
    (root,) = rec.fits()
    assert len(_children(rec, root, "fed.upload")) == 1
    if path == "fedgen":
        (locals_,) = _children(rec, root, "fedgen.locals")
        (server,) = _children(rec, root, "fedgen.server")
        assert len(_children(rec, server, "fedgen.sample")) == 1
        for half in (locals_, server):
            assert len(_children(rec, half, "kmeans.init")) == 1
            assert len(_children(rec, half, "em.loop")) == 1
            (init,) = _children(rec, half, "kmeans.init")
            assert rec.within(init, "kmeans.seed")
            assert rec.within(init, "kmeans.lloyd")
        assert not rec.within(root, "fed.round")
    else:
        assert len(_children(rec, root, "fed.round")) == res.n_rounds
        assert len(_children(rec, root, "kmeans.init")) == 1
        assert not rec.within(root, "em.loop")
        assert not rec.within(root, "fedgen.locals")
    # every loop iteration reads one flag, so syncs are counted
    assert len(rec.within(root, "sync")) >= 2


@pytest.mark.parametrize("path", PATHS)
def test_em_loop_iters_equal_n_iter(path, small_split):
    res, rec, refits = run_recorded(path, small_split)
    (root,) = rec.fits()
    loops = rec.within(root, "em.loop")
    if path == "fedgen":
        (local_loop,) = rec.within(rec.within(root, "fedgen.locals")[0],
                                   "em.loop")
        (refit_loop,) = rec.within(rec.within(root, "fedgen.server")[0],
                                   "em.loop")
        assert local_loop.info["iters"] == max(
            int(r.n_iter) for r in res.local_results)
        assert refit_loop.info["iters"] == int(refits[0].n_iter)
        assert len(loops) == 2
    else:
        assert loops == []
    assert all(set(s.info) <= {"iters"} for s in rec.spans
               if s.name != "fed.upload")


@pytest.mark.parametrize("path", PATHS)
def test_off_records_nothing_and_on_changes_no_bit(path, small_split,
                                                   monkeypatch):
    on, rec, _ = run_recorded(path, small_split)
    assert rec.spans

    def refused(*args, **kwargs):
        raise AssertionError("a span was opened with the recorder off")

    monkeypatch.setattr(tracing, "Span", refused)
    monkeypatch.setattr(tracing, "annotation", refused)
    off = make_runner(path, "cpu").run(small_split, seed=3)
    assert tracing._active is None
    for a, b in zip((on.global_gmm.weights, on.global_gmm.means,
                     on.global_gmm.covs),
                    (off.global_gmm.weights, off.global_gmm.means,
                     off.global_gmm.covs)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("path", PATHS)
def test_spans_are_c_level_profiler_events(path, small_split):
    """Each span opens PyTorch's C-level ``record_function``; a profiler
    of the CPU sees each span as often as the recording holds it."""
    from torch._C._profiler import _RecordFunctionFast
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    assert tracing.annotation is _RecordFunctionFast
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, rec, _ = run_recorded(path, small_split)
    seen, held = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in tracing.SPAN_NAMES:
            seen[e.name] = seen.get(e.name, 0) + 1
    for s in rec.spans:
        held[s.name] = held.get(s.name, 0) + 1
    assert seen == held and held["api.run"] == 1


def test_recording_is_one_block_of_one_thread():
    with tracing.recording() as rec:
        with pytest.raises(RuntimeError):
            with tracing.recording():
                pass
        seen = []
        worker = threading.Thread(
            target=lambda: seen.append(tracing.span("sync")))
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        with tracing.span("api.run"):
            assert tracing.blocking(int, torch.tensor(7)) == 7
            tracing.note("iters", 2)
    assert seen == [tracing._OFF]
    assert [s.name for s in rec.spans] == ["api.run", "sync"]
    assert rec.spans[0].info == {"iters": 2}
    assert rec.format().splitlines() == [
        f"api.run {rec.spans[0].ms:.3f} ms iters=2",
        f"  sync {rec.spans[1].ms:.3f} ms"]
    assert tracing._active is None
    assert tracing.span("api.run") is tracing._OFF


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------

@pytest.fixture
def card_split():
    """A split large enough for both k-means++ branches: each client over
    ``SEED_ROWS`` rows (the seeding and pilot subsamples), and an S of
    16,800 rows with ``h`` = 1,400."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return make_split(np.random.default_rng(7), clients=4, rows=20000, d=8)


def _synchronizing_calls(path, split, record: bool):
    """Each call PyTorch's sync debug mode reports during one fit on the
    card: (file:line of the warning, names of the spans open around it).
    Only the fit's own calls count (the first switch of the mode in a
    process reports one of its own)."""
    runner = make_runner(path, "cuda", h=1400)
    runner.run(split, seed=1)          # builds the kernels, warms the card
    torch.cuda.synchronize()
    calls = []
    rec = None
    live = False

    def seen(message, category, filename, lineno, file=None, line=None):
        if live and "synchroniz" in str(message):
            stack = [] if rec is None else [s.name for s in rec._open]
            calls.append((f"{filename}:{lineno}", stack))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with tracing.recording() if record else nullcontext() as rec:
                live = True
                runner.run(split, seed=2)
                live = False
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return calls, rec


@pytest.mark.cuda
@pytest.mark.parametrize("path", PATHS)
def test_sync_spans_hold_every_synchronizing_call(path, card_split):
    calls, rec = _synchronizing_calls(path, card_split, record=True)
    outside = sorted({where for where, stack in calls
                      if not stack or (stack[-1] != "sync"
                                       and "fed.upload" not in stack)})
    assert calls and not outside, outside
    in_sync = sum(1 for _, stack in calls if stack and stack[-1] == "sync")
    (root,) = rec.fits()
    assert in_sync == len(rec.within(root, "sync"))
    off, _ = _synchronizing_calls(path, card_split, record=False)
    assert len(off) == len(calls)


@pytest.mark.cuda
@pytest.mark.parametrize("path", PATHS)
def test_profiler_sees_each_span_as_recorded(path, card_split):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    runner = make_runner(path, "cuda", h=1400)
    runner.run(card_split, seed=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(32):
            torch.ones(8, device="cuda").add_(1)
        torch.cuda.synchronize()
        with record_function("window"), tracing.recording() as rec:
            runner.run(card_split, seed=2)
            torch.cuda.synchronize()
    cpu = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in tracing.SPAN_NAMES:
            cpu[e.name] = cpu.get(e.name, 0) + 1
    held = {}
    for s in rec.spans:
        held[s.name] = held.get(s.name, 0) + 1
    assert cpu == held
