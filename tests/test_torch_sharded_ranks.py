"""The port's sharded path with real values on four ranks: a gloo group of
4 processes on a (data=2, model=2) mesh, each rank holding its shards of
``DTensor`` parameters, batch and cache laid out by ``param_specs``,
``cache_specs`` and the batch axes (``repro_torch.models.sharding_ctx``,
``launch/steps.py``), against the plain path on the same weights, which
every rank also runs.

At smoke width in float32 (B = 4, S = 64: four MoE groups, two a data
rank, and two query chunks), for a dense (internlm2-1.8b), an MoE
(deepseek-moe-16b), an RG-LRU (recurrentgemma-9b) and an xLSTM
(xlstm-350m) config: prefill (logits and cache), three decode steps from
the plain prefill's cache laid out in the ``"seq"`` cache mode (the
length on the model axis; which rank writes a slot follows its shard),
and a train step on FSDP masters: its forward and backward (the loss
and every gradient) and one AdamW step's metrics. The updated masters
are not compared: AdamW's first step moves each by about ``lr`` times
the sign of its gradient, and a gradient near zero may change sign
under another order of summation. The dense config also decodes in the
``"hd"`` mode and, at B = 1, with the length on both mesh axes
(``seq_axis``). Every ``full_tensor()`` is held to the plain result at
the substrate's float32 bound, 1e-5 (the shards' partial sums add in
another order).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 4
ARCHS = ("internlm2-1.8b", "deepseek-moe-16b", "recurrentgemma-9b",
         "xlstm-350m")
TOL = 1e-5

WORKER = textwrap.dedent("""
import copy, dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config
from repro_torch.launch import steps
from repro_torch.models import sharding_ctx
from repro_torch.models.moe import _expert_axis_sharded
from repro_torch.models.transformer import (cache_specs, init_params,
                                            param_specs)
from repro_torch.optim.adamw import AdamWConfig, init_opt_state

rank, world, store, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=world)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
B, S, CAP, STEPS = 4, 64, 72, 3


def err(got, want):
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((got.detach().double() - want.double()).abs().max()) \\
        if want.numel() else 0.0


def cache_err(got, want):
    return max((err(g[k], w[k]) for g, w in zip(got, want) for k in w),
               default=0.0)


def axes(cfg, batch="data"):
    expert = None
    if cfg.moe is not None and _expert_axis_sharded(cfg.moe, 2):
        expert = "model"
    sharding_ctx.set_axes(batch=batch, model="model", expert=expert)


def decode(cfg, model, dmodel, cache, tokens, b, batch, seq_axis, mode):
    # each step's logits and the last cache, the plain path against the
    # DTensor one from the same cache laid out by cache_specs
    dcache = steps.distribute_tree(
        copy.deepcopy(cache), mesh,
        cache_specs(cfg, batch, seq_axis, mode))
    worst = 0.0
    for t in range(STEPS):
        tok = tokens[:b, t]
        want = steps.make_decode_step(cfg)(model, cache, tok, S + t)
        axes(cfg, batch)
        got = steps.make_decode_step(cfg)(
            dmodel, dcache, steps.distribute_tree(tok, mesh, (batch,)),
            S + t)
        sharding_ctx.clear_axes()
        worst = max(worst, err(got[0], want[0]))
    return worst, cache_err(dcache, cache)


rng = np.random.default_rng(0)
out = {}
for arch in json.loads(sys.argv[5]):
    cfg = dataclasses.replace(get_config(arch, "smoke"),
                              dtype=torch.float32)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))
    more = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, STEPS)))
    model = init_params(0, cfg, "cpu")
    plain = steps.make_prefill_step(cfg, CAP)(model, {"tokens": tokens})
    dmodel = steps.distribute_params(copy.deepcopy(model), mesh,
                                     param_specs(cfg, None, 2))
    axes(cfg)
    logits, cache = steps.make_prefill_step(cfg, CAP)(
        dmodel, steps.distribute_tree({"tokens": tokens}, mesh,
                                      {"tokens": ("data", None)}))
    sharding_ctx.clear_axes()
    row = {"prefill_logits": err(logits, plain[0]),
            "prefill_cache": cache_err(cache, plain[1])}
    row["decode_logits"], row["decode_cache"] = decode(
        cfg, model, dmodel, plain[1], more, B, "data", None, "seq")
    if arch == "internlm2-1.8b":
        _, pc = steps.make_prefill_step(cfg, CAP)(model, {"tokens": tokens})
        row["decode_hd_logits"], row["decode_hd_cache"] = decode(
            cfg, model, dmodel, pc, more, B, "data", None, "hd")
        _, one = steps.make_prefill_step(cfg, CAP)(
            model, {"tokens": tokens[:1]})
        row["decode_b1_logits"], row["decode_b1_cache"] = decode(
            cfg, model, dmodel, one, more, 1, None, "data", "seq")

    masters = init_params(1, cfg, "cpu", master=True)
    dmasters = steps.distribute_params(copy.deepcopy(masters), mesh,
                                       param_specs(cfg, "data", 2))
    tb = {"tokens": tokens,
           "targets": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   (B, S))),
           "mask": torch.as_tensor(rng.random((B, S)) < 0.9,
                                   dtype=torch.float32)}
    dtb = steps.distribute_tree(tb, mesh, {k: ("data", None) for k in tb})
    # the step's forward and backward (in float32 its casts are the
    # masters themselves), every gradient against the plain one
    want = steps._LossAndGrads(masters, cfg)(tb, list(masters.parameters()))
    axes(cfg)
    with steps._mesh_scope(dmasters):
        got = steps._LossAndGrads(dmasters, cfg)(
            dtb, list(dmasters.parameters()))
    row["train_loss"] = err(got[0], want[0])
    row["train_grads"] = max(err(g, w) for g, w in zip(got[2], want[2]))
    sharding_ctx.clear_axes()
    opt = AdamWConfig(warmup_steps=0)
    want = steps.make_train_step(cfg, opt)(masters, init_opt_state(masters),
                                           tb)
    axes(cfg)
    got = steps.make_train_step(cfg, opt)(dmasters, init_opt_state(dmasters),
                                          dtb)
    sharding_ctx.clear_axes()
    row["train_metrics"] = max(abs(got[k] - want[k]) / max(1.0, abs(want[k]))
                               for k in want)
    out[arch] = row
if rank == 0:
    with open(f"{out_dir}/ranks.json", "w") as f:
        json.dump(out, f)
dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("ranks")
    script = work / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(WORLD),
         str(work / "store"), str(work), json.dumps(ARCHS)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=240)[1])
    finally:
        for p in procs:
            p.kill()
    for p, e in zip(procs, errs):
        assert p.returncode == 0, e[-4000:]
    return json.loads((work / "ranks.json").read_text())


@pytest.mark.parametrize("arch", ARCHS)
def test_four_ranks_match_the_plain_path(four_ranks, arch):
    row = four_ranks[arch]
    want = {"prefill_logits", "prefill_cache", "decode_logits",
            "decode_cache", "train_loss", "train_grads", "train_metrics"}
    if arch == "internlm2-1.8b":
        want |= {"decode_hd_logits", "decode_hd_cache", "decode_b1_logits",
                 "decode_b1_cache"}
    assert set(row) == want
    bad = {k: v for k, v in row.items() if not v <= TOL}
    assert not bad, (arch, bad)
