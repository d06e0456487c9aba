"""``repro_torch.launch.dryrun.run_one`` at internlm2-1.8b's full width on
the single-pod fake mesh (256 ranks, (data=16, model=16), ``--device
cpu``), in a subprocess (the fake group is process-global): ``decode_32k``
at full depth and ``train_4k`` cut to two layers (the walk of 24 layers
takes about a minute on a CPU).

- The JSON has the reference's keys (``repro/launch/dryrun.py``).
- ``argument_bytes`` is the exact integer the JAX package's specs give:
  each leaf of ``eval_shape(init_params)`` (float32 masters and their
  AdamW moments for train; the serving tree in bfloat16 for decode), the
  optimizer step, the batch or the cache, token and position, sharded by
  ``param_specs``/``opt_state_specs``/``cache_specs`` and the batch axes.
- ``train_4k`` gathers (FSDP all-gathers) and, over the 256 devices,
  counts the unsharded step's matmul FLOPs (the same step on meta
  tensors, no mesh) within 2%, once the one product the reference's
  layout replicates is added back: the k/v projections, which
  ``attn_specs`` keeps whole over the model axis (``wk``/``wv`` are
  ``P(fsdp, None, None)``) and so every model rank computes for its
  batch shard.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import base as jax_base
from repro.configs import get_config as jax_config
from repro.launch import mesh as jax_mesh
from repro.launch import steps as jax_steps
from repro.models import transformer as jax_tf
from repro.optim import adamw as jax_adamw

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH, CUT = "internlm2-1.8b", 2
AXIS = {"data": 16, "model": 16}
KEYS = {"arch", "shape", "mesh", "kind", "devices", "lower_s", "compile_s",
        "memory", "cost", "collectives", "collective_bytes_total"}

WORKER = """
import dataclasses, json, sys
from pathlib import Path
from repro_torch.configs import base, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.steps import _train_step_tensors
from repro_torch.models.transformer import init_params
from repro_torch.optim.adamw import AdamWConfig, init_opt_state

out_dir = Path(sys.argv[1])
base._ensure_loaded()
base._REGISTRY["internlm2-1.8b"]["cut"] = dataclasses.replace(
    get_config("internlm2-1.8b"), n_layers={cut})
dryrun.init_fake_group(256)
res = {{"train": dryrun.run_one("internlm2-1.8b", "train_4k", False, out_dir,
                               "cut", device_type="cpu"),
       "decode": dryrun.run_one("internlm2-1.8b", "decode_32k", False,
                                out_dir, device_type="cpu")}}
# the unsharded step: plain meta tensors, no mesh
cfg = get_config("internlm2-1.8b", "cut")
model = init_params(0, cfg, "meta", master=True)
args = (model, init_opt_state(model),
        base.input_specs(cfg, "train_4k")["batch"])
res["unsharded_flops"] = dryrun.count_step(
    _train_step_tensors(cfg, AdamWConfig()), args, in_place=2)[
        "cost"]["flops"]
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cells")
    script = tmp / "worker.py"
    script.write_text(textwrap.dedent(WORKER.format(cut=CUT)))
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), str(tmp)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _local_bytes(tree, specs) -> int:
    """Bytes of device 0's shard of every leaf of ``tree`` (shape/dtype
    structs) laid out by the matching ``PartitionSpec`` tree."""
    total = 0
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs,
                                  is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    for leaf, spec in zip(leaves, spec_leaves):
        n = 1
        for i, dim in enumerate(leaf.shape):
            entry = spec[i] if i < len(spec) else None
            ways = 1
            for a in (entry if isinstance(entry, tuple) else
                      () if entry is None else (entry,)):
                ways *= AXIS[a]
            n *= -(-dim // ways)
        total += n * jnp.dtype(leaf.dtype).itemsize
    return total


def _jax_cut():
    import dataclasses
    return dataclasses.replace(jax_config(ARCH), n_layers=CUT)


def test_json_has_the_reference_keys(cells):
    for kind in ("train", "decode"):
        r = cells[kind]
        assert set(r) == KEYS
        assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                    "temp_bytes", "peak_bytes"}
        assert set(r["cost"]) == {"flops", "bytes_accessed",
                                  "transcendentals"}
        assert set(r["collectives"]) == {"all-gather", "all-reduce",
                                         "reduce-scatter", "all-to-all",
                                         "collective-permute"}
        assert r["devices"] == 256 and r["mesh"] == "singlepod"
        m = r["memory"]
        assert m["peak_bytes"] == m["argument_bytes"] + max(
            m["output_bytes"], m["temp_bytes"])
        assert r["collective_bytes_total"] == sum(
            v["bytes"] for v in r["collectives"].values())


def test_train_argument_bytes_are_the_reference_specs(cells):
    cfg = _jax_cut()
    fsdp = jax_mesh.fsdp_axes(False)
    p_specs = jax_tf.param_specs(cfg, fsdp=fsdp, model_axis_size=16)
    params = jax.eval_shape(lambda: jax_tf.init_params(jax.random.key(0),
                                                       cfg))
    opt = jax.eval_shape(lambda: jax_adamw.init_opt_state(params))
    batch = jax_base.input_specs(cfg, "train_4k")["batch"]
    b_specs = jax_steps.batch_specs(cfg, "train_4k", False, "train")
    want = (_local_bytes(params, p_specs)
            + _local_bytes(opt, jax_adamw.opt_state_specs(p_specs))
            + _local_bytes(batch, b_specs))
    assert cells["train"]["memory"]["argument_bytes"] == want


def test_decode_argument_bytes_are_the_reference_specs(cells):
    cfg = jax_config(ARCH)
    p_specs = jax_tf.param_specs(cfg, fsdp=None, model_axis_size=16)
    params = jax_steps._serve_dtype(jax.eval_shape(
        lambda: jax_tf.init_params(jax.random.key(0), cfg)), cfg)
    inputs = jax_base.input_specs(cfg, "decode_32k")
    bax = jax_mesh.batch_axes(False, 128)
    c_specs = jax_tf.cache_specs(cfg, bax, None, "seq")
    want = (_local_bytes(params, p_specs)
            + _local_bytes(inputs["cache"], c_specs)
            + _local_bytes(inputs["token"], P(bax))
            + _local_bytes(inputs["pos"], P()))
    assert cells["decode"]["memory"]["argument_bytes"] == want


def test_train_gathers_and_splits_its_flops_256_ways(cells):
    r = cells["train"]
    assert r["collectives"]["all-gather"]["bytes"] > 0
    cfg = _jax_cut()
    t = 256 * 4096
    # k and v projections, forward (twice: the pattern group is
    # rematerialised) and backward (input and weight gradients)
    kv = cfg.n_layers * 4 * 2 * t * cfg.d_model * 2 * cfg.n_kv_heads * cfg.hd
    unsharded = cells["unsharded_flops"]
    replicated = (AXIS["model"] - 1) * kv
    got = 256 * r["cost"]["flops"]
    assert math.isclose(got, unsharded + replicated, rel_tol=0.02), (
        got, unsharded, replicated)
