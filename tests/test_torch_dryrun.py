"""The port's sharding on ``DTensor`` (``repro_torch.models.sharding_ctx``,
``launch/steps.py``'s layouts, ``launch/dryrun.py``'s trip count), each
run in a subprocess: a process group is process-global.

- Placement parity: on a fake 8-rank (pod=2, data=2, model=2) mesh, every
  rank's shard of a tensor laid out by a spec (``DTensor``'s
  ``compute_local_shape_and_global_offset``) is the index JAX's
  ``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives the same
  device (JAX on 8 host devices in its own subprocess), tuple entries
  included.
- ``constrain`` returns its input, the same object, where the axes are
  not set or the tensor is not a ``DTensor``; at smoke width on a gloo
  (1, 1) mesh of world size one, a dense, an MoE, an RG-LRU and an xLSTM
  config give the plain path's bits with ``DTensor`` parameters and
  batch (prefill: logits and cache), the dense one also through a train
  step and a decode step.
- The sLSTM's trip count: the dry-run's one counted timestep against the
  whole loop, train and prefill, at S = 8 and 16 on a fake (2, 2) mesh.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.models import sharding_ctx

SRC = Path(__file__).resolve().parents[1] / "src"


def _run(code: str, tmp_path: Path, env=None, timeout=240) -> dict:
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(code))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               **(env or {}))
    out = subprocess.run([sys.executable, str(script), str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# (shape, spec) on the (pod=2, data=2, model=2) mesh
CASES = [
    ((8, 4, 6), ("data", None, "model")),
    ((8, 4, 6), (("pod", "data"), "model", None)),
    ((8, 4, 6), (None, ("data", "model"), None)),
    ((8, 4, 6), ("model", "pod", "data")),
    ((16, 4), (("pod", "data", "model"), None)),
    ((4, 8), (None, ("pod", "model"))),
    ((4, 6, 8), ("pod", None, ("data", "model"))),
    ((4, 6), (None, None)),
]

TORCH_SHARDS = """
import json, sys
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.models.sharding_ctx import placements
CASES = {cases!r}
out = []
for rank in range(8):
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=8)
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    row = []
    for shape, spec in CASES:
        size, off = compute_local_shape_and_global_offset(
            shape, mesh, placements(mesh, spec))
        row.append([[o, o + s] for o, s in zip(off, size)])
    out.append(row)
    dist.destroy_process_group()
print(json.dumps(out))
"""

JAX_SHARDS = """
import json
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
CASES = {cases!r}
mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
out = [[None] * len(CASES) for _ in range(8)]
for c, (shape, spec) in enumerate(CASES):
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    for r, dev in enumerate(mesh.devices.flat):
        out[r][c] = [[s.start or 0, dim if s.stop is None else s.stop]
                     for s, dim in zip(idx[dev], shape)]
print(json.dumps(out))
"""


def test_placements_match_jax_devices_indices_map(tmp_path):
    got = _run(TORCH_SHARDS.format(cases=CASES), tmp_path)
    want = _run(JAX_SHARDS.format(cases=CASES), tmp_path, env={
        "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        "JAX_PLATFORMS": "cpu"})
    assert got == want


def test_constrain_is_the_input_without_axes_or_dtensor():
    x = torch.ones(4, 3)
    sharding_ctx.clear_axes()
    assert sharding_ctx.constrain(x, ("batch", None)) is x
    sharding_ctx.set_axes(batch="data")
    try:
        assert sharding_ctx.constrain(x, ("batch", None)) is x
        assert sharding_ctx.axis_size(x, "batch") == 1
    finally:
        sharding_ctx.clear_axes()
    w = torch.ones(3, 5)
    assert torch.equal(sharding_ctx.einsum("ab,bc->ac", x, w, shard={}), x @ w)


WORLD_ONE = """
import copy, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models import sharding_ctx
from repro_torch.models.transformer import init_params, param_specs
from repro_torch.optim.adamw import AdamWConfig, init_opt_state

tmp = sys.argv[1]
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=0,
                        world_size=1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
rng = np.random.default_rng(0)
B, S = 2, 24


def same(a, b):
    a = a.full_tensor() if hasattr(a, "full_tensor") else a
    return bool(torch.equal(a, b))


def same_cache(dc, pc):
    return all(same(d[k], p[k]) for d, p in zip(dc, pc) for k in p)


out = {}
for arch in ("internlm2-1.8b", "deepseek-moe-16b", "recurrentgemma-9b",
             "xlstm-350m"):
    cfg = get_config(arch, "smoke")
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))
    model = init_params(0, cfg, "cpu")
    plain = steps.make_prefill_step(cfg, S)(model, {"tokens": tokens})
    sharding_ctx.set_axes(batch="data", model="model",
                          expert="model" if cfg.moe else None)
    dmodel = steps.distribute_params(copy.deepcopy(model), mesh,
                                     param_specs(cfg, "data", 1))
    batch = steps.distribute_tree({"tokens": tokens}, mesh,
                                  {"tokens": ("data", None)})
    logits, cache = steps.make_prefill_step(cfg, S)(dmodel, batch)
    row = {"logits": same(logits, plain[0]),
           "cache": same_cache(cache, plain[1])}
    if arch == "internlm2-1.8b":
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B,)))
        want = steps.make_decode_step(cfg)(model, plain[1], tok, S - 1)
        got = steps.make_decode_step(cfg)(
            dmodel, cache, steps.distribute_tree(tok, mesh, ("data",)),
            S - 1)
        row["decode"] = same(got[0], want[0]) and same_cache(got[1],
                                                             want[1])
        sharding_ctx.clear_axes()
        masters = init_params(1, cfg, "cpu", master=True)
        tb = {"tokens": tokens,
              "targets": torch.as_tensor(
                  rng.integers(0, cfg.vocab_size, (B, S))),
              "mask": torch.ones(B, S)}
        opt = AdamWConfig(warmup_steps=0)
        dmasters = copy.deepcopy(masters)
        want = steps.make_train_step(cfg, opt)(masters,
                                               init_opt_state(masters), tb)
        sharding_ctx.set_axes(batch="data")
        p_specs = param_specs(cfg, "data", 1)
        steps.distribute_params(dmasters, mesh, p_specs)
        got = steps.make_train_step(cfg, opt)(
            dmasters, init_opt_state(dmasters),
            steps.distribute_tree(tb, mesh, {k: ("data", None)
                                             for k in tb}))
        row["train_metrics"] = got == want
        row["train_params"] = all(
            same(dmasters.get_parameter(n), p)
            for n, p in masters.named_parameters())
    sharding_ctx.clear_axes()
    out[arch] = row
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_dtensor_at_world_size_one_is_the_plain_bits(tmp_path):
    out = _run(WORLD_ONE, tmp_path)
    assert set(out) == {"internlm2-1.8b", "deepseek-moe-16b",
                        "recurrentgemma-9b", "xlstm-350m"}
    for arch, row in out.items():
        assert all(row.values()), (arch, row)
    assert set(out["internlm2-1.8b"]) == {"logits", "cache", "decode",
                                          "train_metrics", "train_params"}


TRIPS = """
import dataclasses, json
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import base, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.steps import build_jitted
from repro_torch.models import sharding_ctx

dryrun.init_fake_group(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
# rematerialised, as the full configs train: the counted step's backward
# must not replay the group
cfg = dataclasses.replace(get_config("xlstm-350m", "smoke"),
                          pattern=("slstm",), n_layers=1, remat=True)
out = {}
for kind in ("train", "prefill"):
    for s in (8, 16):
        base.INPUT_SHAPES["short"] = {"seq_len": s, "global_batch": 32,
                                      "kind": kind}
        step, args = build_jitted(cfg, "short", mesh, multi_pod=False)
        one = dryrun.count_step(step, args,
                                in_place=2 if kind == "train" else 0)
        step, args = build_jitted(cfg, "short", mesh, multi_pod=False)
        with dryrun.DeviceCounter() as counter:     # the whole loop
            step(*args)
        loop = counter.result()
        sharding_ctx.clear_axes()
        for name, r in (("one", one), ("loop", loop)):
            out[f"{kind}/{s}/{name}"] = {
                "flops": r["cost"]["flops"],
                "transcendentals": r["cost"]["transcendentals"],
                "collectives": r["collectives"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def trips(tmp_path_factory):
    return _run(TRIPS, tmp_path_factory.mktemp("trips"))


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_slstm_trip_count_matches_the_loop(trips, kind):
    """One timestep counted S - 1 times after the first gives the loop's
    FLOPs and transcendentals, and each collective's count and bytes grow
    with S as the loop's do; the stand-in for the stacked hidden states
    may differ from the loop's by one collective of a kind, whatever S."""
    for s in (8, 16):
        one, loop = trips[f"{kind}/{s}/one"], trips[f"{kind}/{s}/loop"]
        assert one["flops"] == loop["flops"] > 0
        assert one["transcendentals"] == loop["transcendentals"] > 0
        for k, v in loop["collectives"].items():
            assert abs(one["collectives"][k]["count"] - v["count"]) <= 1
    for k in trips[f"{kind}/8/loop"]["collectives"]:
        for f in ("count", "bytes"):
            grow = [trips[f"{kind}/16/{w}"]["collectives"][k][f]
                    - trips[f"{kind}/8/{w}"]["collectives"][k][f]
                    for w in ("one", "loop")]
            assert grow[0] == grow[1], (k, f, grow)
