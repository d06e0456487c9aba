"""The benchmark's driver: one run of one cell.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``perfbench/configs/<config>.json``) and a traffic mix
(``perfbench/traffic/<traffic>.json``, whose ``entry`` names the module in
``perfbench/entries`` that drives the program); its limits are
``perfbench/limits/<workload>.json`` and each per-layer metric is read by
``perfbench/metrics/<metric>.py``. Nothing here names a cell, so a later
cell, configuration, mix or metric is new files and new entries only.

A run: the split from ``--seed`` and one warm-up fit at the cell's shapes
(set-up, which builds the kernels on a checkout's first run); then whole
fits back to back, each on a seed drawn from ``--seed`` and ending in a
synchronize, until ``--seconds`` have passed; then the float64 judge on a
sample of the window's fits, drawn from the seed.
"""
from __future__ import annotations

import importlib
import json
import os
import random
import subprocess
import sys
import time
import traceback
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "perfbench-cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 4.0      # the traced window's length, at most
KEEP = 2                 # fits of the window the judge reads
GIB = 2.0 ** 30


class Refused(Exception):
    """A run that must end without a result (no card, a forbidden module)."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its files, and
    the metrics it reports: an end-to-end metric with no ``workloads`` key
    is every cell's; a per-layer one without it is every cell's that
    reports the end-to-end metric it moves."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    pkg = root / "perfbench"
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(workload, int(w["chips"]),
                json.loads((root / conf["file"]).read_text()),
                json.loads((pkg / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
                json.loads((pkg / "limits" / f"{workload}.json")
                           .read_text()), e2e, per_layer)


def fit_seed(seed: int, i: int) -> int:
    """The seed of the window's fit ``i`` (0 is the warm-up fit)."""
    state = np.random.SeedSequence([int(seed), int(i)]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


def use_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so only
    a checkout's first run builds; no library loads JAX on its own."""
    CACHE.mkdir(parents=True, exist_ok=True)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


# ----------------------------------------------------------------------
# Spans and the work count of the traced run
# ----------------------------------------------------------------------

class Spans:
    """Host spans installed around the program's own calls, each with a
    synchronize at its boundaries and a profiler annotation of its name."""

    def __init__(self, sync):
        self.sync = sync
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)

    @contextmanager
    def around(self, module, attr: str, name: str):
        from torch.profiler import record_function
        fn = getattr(module, attr)

        def spanned(*args, **kwargs):
            self.sync()
            with record_function(name):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self.sync()
                self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1
            return out

        setattr(module, attr, spanned)
        try:
            yield
        finally:
            setattr(module, attr, fn)


class Work:
    """The work the fit's two kernel entries are handed, counted from
    their arguments (the rows that carry weight, d and K): operations,
    bytes and the least seconds they could take, summed on the device
    without a synchronize."""

    def __init__(self):
        self.totals = {}

    def add(self, kind: str, rows, d: int, k: int) -> None:
        from perfbench import work
        fn = work.estep_work if kind == "estep" else work.sweep_work
        flops, nbytes = fn(1.0, d, k)
        per_row = (flops, nbytes, work.least_seconds(flops, nbytes))
        r = rows.double()
        old = self.totals.get(kind, (0.0, 0.0, 0.0))
        self.totals[kind] = tuple(o + r * v for o, v in zip(old, per_row))

    def read(self) -> dict:
        """{kind: (operations, bytes, least seconds)}."""
        return {k: tuple(float(v) for v in t) for k, t in self.totals.items()}

    @contextmanager
    def installed(self):
        import torch
        from repro_torch.kernels import ops
        estep, sweep = ops.estep_stats, ops.kmeans_sweep

        def estep_counted(x, means, variances, log_weights,
                          sample_weight=None):
            rows = (sample_weight.sum() if sample_weight is not None else
                    torch.tensor(float(x.shape[:-1].numel()),
                                 device=x.device))
            self.add("estep", rows, x.shape[-1], means.shape[-2])
            return estep(x, means, variances, log_weights, sample_weight)

        def sweep_counted(x, w, centers, with_idx=False):
            self.add("sweep", w.sum(), x.shape[-1], centers.shape[-2])
            return sweep(x, w, centers, with_idx=with_idx)

        ops.estep_stats, ops.kmeans_sweep = estep_counted, sweep_counted
        try:
            yield self
        finally:
            ops.estep_stats, ops.kmeans_sweep = estep, sweep


@dataclass
class TraceData:
    """What a per-layer metric's reader reads."""
    cell: str
    fits: int
    elapsed_s: float
    iterations: list
    span_s: dict
    span_calls: dict
    work: dict
    busy_s: float = 0.0
    window_s: float = 0.0
    kernel_s: dict = field(default_factory=dict)
    family_s: dict = field(default_factory=dict)
    idle_by_label: dict = field(default_factory=dict)


def read_trace(prof, labels: tuple) -> dict:
    """From a profiler trace: the traced window's length, the device's busy
    time in it, device seconds by operation and by kernel family (an
    ``estep_kernel`` or ``sweep_kernel`` launch with the port's
    ``tile_reduce::reduce_kernel`` pass that follows it), and the idle time
    by the innermost host span it falls in (``harness`` between fits).
    The host spans' own markers on the device timeline are not device
    work and are left out."""
    from torch.autograd import DeviceType
    events = prof.events()
    win = [e for e in events if e.name == "window"
           and e.device_type == DeviceType.CPU]
    if not win:
        return {}
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == DeviceType.CUDA
                  and e.name not in labels
                  and w0 <= e.time_range.start < w1), key=lambda t: t[0])
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.name in labels and e.device_type == DeviceType.CPU]
    kernel, family = defaultdict(float), defaultdict(float)
    prev = None
    for s, e, name in dev:
        kernel[name] += (e - s) / 1e6
        fam = ("estep" if "estep_kernel" in name else
               "sweep" if "sweep_kernel" in name else
               prev if "tile_reduce::reduce_kernel" in name else None)
        if fam is not None:
            family[fam] += (e - s) / 1e6
        prev = fam if "reduce_kernel" not in name else None
    busy, idle = 0.0, defaultdict(float)
    cur = w0
    for s, e, _ in dev:
        if s > cur:
            mid = 0.5 * (cur + s)
            inner = [sp for sp in spans if sp[0] <= mid <= sp[1]]
            label = (min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner
                     else "harness")
            idle["harness" if label == "window" else label] += \
                (s - cur) / 1e6
        busy += max(0.0, min(e, w1) - max(s, cur)) / 1e6
        cur = max(cur, e)
    if cur < w1:
        idle["harness"] += (w1 - cur) / 1e6
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy,
            "kernel_s": dict(kernel), "family_s": dict(family),
            "idle_by_label": dict(idle)}


# ----------------------------------------------------------------------
# One run
# ----------------------------------------------------------------------

def run_window(runner, split, seed: int, seconds: float, sync,
               on_fit=None):
    """Whole fits back to back until ``seconds`` have passed: (fits, their
    wall, the results kept for the judge, each fit's iterations). The kept
    fits are a uniform sample of the window's, drawn from ``seed``."""
    keep_rng = random.Random(seed)
    kept, iters, fits = [], [], 0
    t0 = time.perf_counter()
    while True:
        fits += 1
        s = fit_seed(seed, fits)
        res = runner.fit(split, s)
        sync()
        if on_fit is not None:
            iters.append(on_fit(res))
        if len(kept) < KEEP:
            kept.append(res)
        else:
            j = keep_rng.randrange(fits)
            if j < KEEP:
                kept[j] = res
        if time.perf_counter() - t0 >= seconds:
            break
    return fits, time.perf_counter() - t0, kept, iters


def judge(runner, split, kept, limits: dict, device) -> tuple:
    """(correct, failed fits, {number: [worst reading, limit]}) over the
    kept fits."""
    from perfbench import check
    rows = check.client_rows(split, device)
    worst, failed = {}, 0
    for res in kept:
        nums = runner.numbers(runner.form(res), rows, split)
        failed += 0 if check.decide(nums, limits)[0] else 1
        for k, v in nums.items():    # a NaN stays the worst
            worst[k] = v if k not in worst or not v <= worst[k] else worst[k]
    return failed == 0, failed, check.decide(worst, limits)[1]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             require_card: bool = True) -> dict:
    """One run of ``cell``: the result line's object, with ``checks``
    last."""
    import torch
    from perfbench import data
    on_card = device == "cuda"
    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        raise Refused(f"the cell needs {cell.chips} CUDA card(s); found "
                      f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    entry = importlib.import_module(f"perfbench.entries.{cell.traffic['entry']}")
    runner = entry.Runner(cell.config, cell.traffic, device)
    if on_card:
        torch.empty(1, device=device)
    t_import = time.perf_counter()
    split = data.make_split(cell.config, seed)
    t_split = time.perf_counter()
    runner.fit(split, fit_seed(seed, 0))
    sync()
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    print(f"setup: imports and card {t_import - t_start:.3f} s, split "
          f"{t_split - t_import:.3f} s, warm-up fit {t_warm - t_split:.3f} s",
          file=sys.stderr)
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    out = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if not trace:
        fits, elapsed, kept, _ = run_window(runner, split, seed, seconds,
                                            sync)
        window_peak = torch.cuda.max_memory_allocated() if on_card else 0
        values = {"setup_s": setup_s, "fit_s": elapsed / fits,
                  "peak_gib": window_peak / GIB}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        out["metrics"] = {k: {"value": values[k], "unit": units[k]}
                          for k in units}
        tdata = None
    else:
        fits, elapsed, kept, tdata = traced_window(
            runner, split, seed, min(seconds, TRACE_SECONDS), sync, cell,
            on_card)
        window_peak = torch.cuda.max_memory_allocated() if on_card else 0
        out["metrics"] = read_metrics(cell, tdata)
    out["attempted"] = fits
    out["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell.chips, "memory_peak_bytes": max(setup_peak,
                                                      window_peak)}
    if tdata is not None:
        out["device"].update(busy_s=tdata.busy_s, window_s=tdata.window_s)
        out["breakdown"] = {
            "device_ops": [[k[:100], v] for k, v in sorted(
                tdata.kernel_s.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": sorted(tdata.idle_by_label.items(),
                                key=lambda kv: -kv[1])[:10]}
    bad = forbidden_modules()
    if bad:
        raise Refused(f"modules of JAX or the JAX package were loaded: "
                      f"{', '.join(bad)}")
    ok, failed, table = judge(runner, split, kept, cell.limits,
                              torch.device(device))
    out["correct"], out["failed"] = ok, failed
    out["card"] = power_limit() if on_card else "cpu"
    out["checks"] = table
    return out


def traced_window(runner, split, seed, seconds, sync, cell, on_card: bool):
    """The window under ``torch.profiler`` with the entry's spans and the
    work count installed. A few small kernels run first, inside the
    profiler and before the window, since a trace can drop the first
    events of its window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    spans, work = Spans(sync), Work()
    fit = runner.fit

    def fit_span(split, s):
        with record_function("fit"):
            return fit(split, s)

    runner.fit = fit_span
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    dev = "cuda" if on_card else "cpu"
    with runner.spans(spans), work.installed(), profile(activities=acts) \
            as prof:
        for _ in range(32):
            torch.ones(8, device=dev).add_(1)
        sync()
        with record_function("window"):
            fits, elapsed, kept, iters = run_window(
                runner, split, seed, seconds, sync,
                on_fit=runner.iterations)
    runner.fit = fit
    labels = ("window", "fit") + tuple(spans.calls)
    got = read_trace(prof, labels) if on_card else {}
    tdata = TraceData(cell.name, fits, elapsed, iters, dict(spans.seconds),
                      dict(spans.calls), work.read(), **got)
    return fits, elapsed, kept, tdata


def read_metrics(cell: Cell, tdata: TraceData) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        mod = importlib.import_module(f"perfbench.metrics.{m['name']}")
        value = mod.read(tdata)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv: list, t_start: float) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    use_cache_dirs()
    sys.path.insert(0, str(ROOT / "src"))
    try:
        cell = load_cell(args.workload)
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       t_start)
    except Refused as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 3
    except Exception:
        traceback.print_exc()
        return 1
    print(f"card: {out['card']}", file=sys.stderr)
    for name, (value, limit) in out["checks"].items():
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0
