"""Multi-pod dry-run: run every (architecture x input-shape x mesh) cell's
step once on meta ``DTensor``s over the production mesh, and record what
one device would hold and do: memory, cost and the collectives (port of
``repro/launch/dryrun.py``).

The reference lowers and compiles each cell against a forced 256- or
512-device host platform and asks XLA. Torch has no whole-program compiler
to ask, so here the step runs eagerly, once, on rank 0 of a fake process
group of 256 or 512 ranks (``FakeStore``), its arguments meta ``DTensor``s
laid out by the specs (``launch/steps.py::build_jitted``): sharding
propagation gives every op its local shapes, the collectives it inserts
run on the meta shards, and nothing is allocated. A dispatch mode
(:class:`DeviceCounter`) sees each op on the local tensors, after
``DTensor`` has split it, and counts there, so every figure is per
device:

- ``cost.flops``: the matmul FLOPs (``torch.utils.flop_counter``'s
  formulas: mm, bmm, addmm, baddbmm, convolution, attention) of the local
  shapes. XLA's ``cost_analysis`` counts elementwise arithmetic too and
  counts a scanned layer body once (``benchmarks/roofline.py``); the
  port's layer loop is unrolled and every layer counts, so the two
  ``flops`` figures are not expected to agree.
- ``cost.transcendentals``: output elements of exp, log, tanh, sigmoid,
  rsqrt, sqrt, softmax, gelu, silu and their kin (input elements of a
  logsumexp), forward and backward.
- ``cost.bytes_accessed``: bytes read and written by every op that is not
  a view, unfused (XLA counts after fusion).
- ``collectives``: count and output bytes of each ``c10d_functional``
  collective on the local tensors, summed per kind (the reference sums
  each collective's output type).
- ``memory``: ``argument_bytes`` the local shard bytes of the step's
  arguments (parameters, optimizer state and batch; or parameters, cache,
  token and position); ``output_bytes`` the same of its results (the
  updated parameters and optimizer state and the metrics; or logits and
  cache); ``temp_bytes`` the peak of the live bytes of the local tensors
  the step itself creates (a storage counts from the op that makes it
  until it is freed; outputs count while they are made);
  ``peak_bytes = argument + max(output, temp)``, the reference's formula.
  The port keeps the optimizer's step and the decode position on the
  host; each counts as the reference's int32 scalar (4 bytes).

The sLSTM's time loop would cost millions of eager dispatches at the
shapes here. For the run, ``xlstm.slstm_time_loop`` is replaced by
:func:`_counted_time_loop`: its cell runs once and every count it makes,
forward and backward, is multiplied by the sequence length, as the
reference's HLO walk multiplies a while body by its trip count; the
(trips - 1) copies of the state the loop would keep alive are added to
the live bytes while it would hold them.

``lower_s`` is the time to build the cell's meta arguments and step, and
``compile_s`` the time of the counted run (there is nothing to lower or
compile).

MUST run as its own process: the fake group is process-global.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.models import xlstm as xlstm_mod

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d_functional op name (its prefix) -> the reference's HLO kind
_KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "permute": "collective-permute", "broadcast": "collective-permute"}

_aten = torch.ops.aten
# ops whose every output element costs one transcendental evaluation
_TRANSCENDENTAL = {
    _aten.exp, _aten.exp2, _aten.expm1, _aten.log, _aten.log1p, _aten.log2,
    _aten.tanh, _aten.sigmoid, _aten.rsqrt, _aten.sqrt, _aten.sin,
    _aten.cos, _aten.erf, _aten._softmax, _aten._log_softmax, _aten.gelu,
    _aten.gelu_backward, _aten.silu, _aten.silu_backward, _aten.logaddexp,
    _aten.log_sigmoid_forward, _aten.log_sigmoid_backward, _aten.softplus,
    _aten.pow, _aten._foreach_sqrt, _aten._foreach_exp}
# reductions that evaluate one transcendental an input element
_TRANSCENDENTAL_IN = {_aten.logsumexp}


def _tensors(tree, out=None) -> list:
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of the tensors of ``tree`` (a plain
    tensor counts whole); a Python int or float counts as an int32/float32
    scalar (the reference's on-device step and position)."""
    total = 0
    leaves = [list(x.parameters()) if isinstance(x, torch.nn.Module) else x
              for x in torch.utils._pytree.tree_leaves(tree)]
    for leaf in torch.utils._pytree.tree_leaves(leaves):
        if isinstance(leaf, DTensor):
            total += _nbytes(leaf.to_local())
        elif isinstance(leaf, torch.Tensor):
            total += _nbytes(leaf)
        elif isinstance(leaf, (int, float)) and not isinstance(leaf, bool):
            total += 4
    return total


class DeviceCounter(TorchDispatchMode):
    """Counts one rank's work: every op ``DTensor`` runs on its local
    tensors, with those tensors' shapes.

    An op on ``DTensor``s is handed back (``NotImplemented``) so that
    ``DTensor`` propagates its sharding, inserts its collectives and calls
    the op on the local shards, which this mode then sees and counts. The
    fake tensors of ``DTensor``'s shape propagation pass through
    uncounted. Counts made inside :meth:`repeat` are multiplied."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.transcendentals = 0
        self.bytes_accessed = 0
        self.collectives = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
        self.trips = 1
        self.live = 0
        self.peak = 0
        self._storages: dict[int, weakref.ref] = {}

    @contextlib.contextmanager
    def repeat(self, trips: int):
        """Count every op inside ``trips`` times."""
        saved, self.trips = self.trips, self.trips * trips
        try:
            yield
        finally:
            self.trips = saved

    def add_live(self, nbytes: int) -> None:
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def _track(self, inputs, outputs) -> None:
        """Count the storages ``outputs`` hold that no input holds and that
        are not yet counted, until each is freed."""
        seen = {id(t.untyped_storage()) for t in inputs}
        for t in outputs:
            st = t.untyped_storage()
            key = id(st)
            if key in seen or (key in self._storages
                               and self._storages[key]() is st):
                continue
            nbytes = st.nbytes()
            self._storages[key] = weakref.ref(st)
            weakref.finalize(st, self._free, key, nbytes)
            self.add_live(nbytes)

    def _free(self, key: int, nbytes: int) -> None:
        self._storages.pop(key, None)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        # a view moves no bytes and makes no storage
        if isinstance(func, torch._ops.HigherOrderOperator) or func.is_view:
            return out
        packet = func._overloadpacket
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs):
            return out      # a factory of DTensor's shape propagation
        n = self.trips
        if packet in flop_registry:
            self.flops += n * flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
        if packet in _TRANSCENDENTAL:
            self.transcendentals += n * sum(t.numel() for t in outs)
        elif packet in _TRANSCENDENTAL_IN:
            self.transcendentals += n * ins[0].numel()
        if func.namespace == "_c10d_functional":
            name = packet.__name__
            kind = next((k for p, k in _KIND.items()
                         if name.startswith(p)), None)
            if kind is not None:
                self.collectives[kind]["count"] += n
                self.collectives[kind]["bytes"] += n * sum(
                    _nbytes(t) for t in outs)
        else:
            self.bytes_accessed += n * sum(_nbytes(t) for t in ins + outs)
        self._track(ins, outs)
        return out

    def result(self) -> dict:
        return {"cost": {"flops": float(self.flops),
                         "bytes_accessed": float(self.bytes_accessed),
                         "transcendentals": float(self.transcendentals)},
                "collectives": self.collectives,
                "collective_bytes_total": sum(
                    v["bytes"] for v in self.collectives.values())}


class _Repeated(torch.autograd.Function):
    """``fn(*inputs)`` run once and counted ``trips`` times, forward and
    backward, by ``counter``."""

    @staticmethod
    def forward(ctx, counter, trips, fn, *inputs):
        ctx.counter, ctx.trips = counter, trips
        ctx.set_materialize_grads(False)
        ctx.inputs = [t.detach().requires_grad_(t.requires_grad)
                      for t in inputs]
        before = counter.live
        # the step's own graph keeps its tensors: a rematerialised group's
        # hooks would recompute the whole group inside the counted
        # backward below
        with torch.enable_grad(), counter.repeat(trips), \
                torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                         lambda t: t):
            ctx.outputs = fn(*ctx.inputs)
        # the loop keeps each step's outputs and residuals until backward
        ctx.phantom = (trips - 1) * max(counter.live - before, 0)
        counter.add_live(ctx.phantom)
        return tuple(o.detach() for o in ctx.outputs)

    @staticmethod
    def backward(ctx, *grads):
        wanted = [t for t in ctx.inputs if t.requires_grad]
        used = [(o, g) for o, g in zip(ctx.outputs, grads) if g is not None]
        with ctx.counter.repeat(ctx.trips):
            got = iter(torch.autograd.grad([o for o, _ in used], wanted,
                                           [g for _, g in used],
                                           allow_unused=True))
        ctx.counter.live -= ctx.phantom
        return (None, None, None) + tuple(
            next(got) if t.requires_grad else None for t in ctx.inputs)


def _counted_time_loop(counter: DeviceCounter):
    """A stand-in for ``xlstm.slstm_time_loop`` that counts its loop, not
    runs it: the first timestep runs as the loop's does (from the zero
    state, which takes no gradient), then one steady-state timestep runs
    on its output and counts, forward and backward (its state's gradient
    included), ``S - 1`` times. The stacked h is the last step's,
    broadcast over S: the loop's shapes, placements and collectives (meta
    tensors have no values to differ). The loop's per-step slices of the
    input projection move bytes that are counted for two steps only."""

    def loop(cell, wx, state, weights: tuple):
        b, s = wx.shape[:2]
        state = cell(wx[:, 0], state, *weights)
        keys, nw = tuple(state), len(weights)
        if s > 1:
            def steady(wx_t, *rest):
                new = cell(wx_t, dict(zip(keys, rest[nw:])), *rest[:nw])
                return tuple(new[k] for k in keys)
            inputs = (wx[:, 1],) + tuple(weights) + tuple(
                state[k] for k in keys)
            if torch.is_grad_enabled():
                out = _Repeated.apply(counter, s - 1, steady, *inputs)
            else:
                with counter.repeat(s - 1):
                    out = steady(*inputs)
            state = dict(zip(keys, out))
        h = state["h"]
        # without gradients the loop keeps each step's h (for the stack)
        phantom = 0 if torch.is_grad_enabled() or s <= 2 else \
            (s - 2) * local_bytes(h)
        counter.add_live(phantom)
        hs = h[:, None].expand(b, s, *h.shape[1:]).contiguous()
        counter.live -= phantom
        return hs, state

    return loop


@contextlib.contextmanager
def counted(counter: DeviceCounter):
    """Run under ``counter``, the sLSTM's loop counted as one step times
    its length."""
    saved = xlstm_mod.slstm_time_loop
    xlstm_mod.slstm_time_loop = _counted_time_loop(counter)
    try:
        with counter:
            yield counter
    finally:
        xlstm_mod.slstm_time_loop = saved


def count_step(step, args, *, in_place: int = 0) -> dict:
    """Run ``step(*args)`` once under a :class:`DeviceCounter` and return
    its cost, collectives and memory (the module docstring's keys). The
    first ``in_place`` arguments are updated in place by the step and
    count among its outputs (the train step's parameters and optimizer
    state)."""
    counter = DeviceCounter()
    arg_bytes = local_bytes(args)
    with counted(counter):
        out = step(*args)
        out_bytes = local_bytes((args[:in_place], out))
        temp = counter.peak
    del out
    res = counter.result()
    res["memory"] = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                     "temp_bytes": temp,
                     "peak_bytes": arg_bytes + max(out_bytes, temp)}
    return res


def init_fake_group(world_size: int) -> None:
    """Initialise this process's default group as a fake group of
    ``world_size`` ranks, this process rank 0 (collectives on it do
    nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def run_one(arch: str, shape: str, multi_pod: bool, out_dir: Path,
            variant: str = "full", decode_cache_mode: str = "seq",
            tag: str = "", device_type: str = "cuda") -> dict:
    """One cell on the production mesh over the already initialised fake
    group; writes ``<arch>__<shape>__<mesh>.json`` and returns it."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_jitted
    from repro_torch.models import sharding_ctx

    mesh_name = ("multipod" if multi_pod else "singlepod") + tag
    cfg = get_config(arch, variant)
    mesh = make_production_mesh(multi_pod=multi_pod,
                                device_type=device_type)
    t0 = time.time()
    step, args = build_jitted(cfg, shape, mesh, multi_pod=multi_pod,
                              decode_cache_mode=decode_cache_mode)
    t_build = time.time() - t0
    try:
        counts = count_step(step, args, in_place=2 if
                            INPUT_SHAPES[shape]["kind"] == "train" else 0)
    finally:
        sharding_ctx.clear_axes()
    t_walk = time.time() - t0 - t_build
    result = {
        "arch": arch, "shape": shape, "mesh": mesh_name,
        "kind": INPUT_SHAPES[shape]["kind"],
        "devices": int(mesh.size()),
        "lower_s": round(t_build, 1), "compile_s": round(t_walk, 1),
        "memory": counts["memory"], "cost": counts["cost"],
        "collectives": counts["collectives"],
        "collective_bytes_total": counts["collective_bytes_total"],
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{arch}__{shape}__{mesh_name}"
    (out_dir / f"{name}.json").write_text(json.dumps(result, indent=2))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="full")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--decode-cache-mode", default="seq",
                    choices=["hd", "seq"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type of the mesh (the tensors are meta)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: --device cuda but torch.cuda.is_available() is "
              "False; pass --device cpu", file=sys.stderr)
        return 2

    out_dir = Path(args.out)
    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or not args.shape \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for mp in meshes:
        init_fake_group(512 if mp else 256)
        for arch, shape in [(a, s) for a in archs for s in shapes]:
            mesh_name = ("multipod" if mp else "singlepod") + args.tag
            name = f"{arch}__{shape}__{mesh_name}"
            if args.skip_existing and (out_dir / f"{name}.json").exists():
                print(f"[skip] {name}")
                continue
            try:
                r = run_one(arch, shape, mp, out_dir, args.variant,
                            args.decode_cache_mode, args.tag, args.device)
                coll = {k: v["bytes"] for k, v in r["collectives"].items()
                        if v["count"]}
                print(f"[ok] {name}: flops={r['cost']['flops']:.4e} "
                      f"coll={r['collective_bytes_total']:.4e}B {coll} "
                      f"peak={r['memory']['peak_bytes']:.4e}B "
                      f"build={r['lower_s']}s walk={r['compile_s']}s",
                      flush=True)
            except Exception as e:
                failures.append((name, repr(e)))
                print(f"[FAIL] {name}: {e}", flush=True)
                traceback.print_exc()
        dist.destroy_process_group()
    if failures:
        print(f"{len(failures)} failures:")
        for n, e in failures:
            print(" ", n, e)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
