"""The port's xLSTM blocks (``repro_torch.models.xlstm``) and the xlstm-350m
family against the JAX package's on the same numpy inputs and the same
weights, at the smoke config on the CPU.

Tolerances:

- float32 block outputs, states, logits and losses: rtol/atol 1e-5;
- gradients: 1e-4 relative to each tensor's largest entry;
- bfloat16: atol 5e-2 on outputs of order 1 (tests/test_torch_models.py).

- float64 (both packages with every float32 they name made float64), the
  24-layer stack: loss 1e-12 relative, gradients 1e-8 relative to each
  tensor's largest entry.

Prefill -> decode against the full forward (the parallel form's
stabiliser and the recurrent one differ, in both packages) and the JAX
engine's greedy tokens: tests/test_torch_models.py and
tests/test_torch_launch_serve.py.

Run as a script, this file prints both packages' ``make_train_step``
losses and gradient norms on ``data.tokens.batches`` at a chosen width
and depth (``python tests/test_torch_xlstm.py --help``).
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as jtr
from repro.models import xlstm as jx
from repro_torch.configs import get_config
from repro.launch import steps as jsteps
from repro.optim import adamw as jadam
from repro_torch.convert import model_params_from_jax
from repro_torch.data.tokens import batches
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttr
from repro_torch.optim import AdamWConfig, init_opt_state
from test_torch_train import (as_jax_leaves, check_grads,
                              check_train_forward, jax_leaves)
from repro_torch.models import xlstm as tx

ARCH = "xlstm-350m"
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 5e-2
DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
D, DIMS = 64, jx.XLSTMDims(n_heads=4, head_dim=32)
MLSTM_KEYS = ("w_up", "wq", "wk", "wv", "w_if", "b_if", "w_down")
SLSTM_KEYS = ("w_in", "r", "b", "w_up", "w_down")
F32_LEAVES = {"b_if", "b", "r"}


def np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, dtype=np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(np32(got), np32(want), **(tol or F32))


def close_rel(got, want, rel=1e-4):
    got, want = np32(got), np32(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rel * float(np.abs(want).max())


def carried(p: dict, keys, cls, dtype=torch.float32):
    """The JAX block's float32 leaves as a port module: matrices in
    ``dtype``, the leaves the reference reads in float32 kept float32."""
    leaves = [torch.as_tensor(np.array(p[k])) for k in keys]
    return cls(*(t if k in F32_LEAVES else t.to(dtype)
                 for k, t in zip(keys, leaves)))


def mlstm_block(seed=0, dtype=torch.float32):
    p = jx.mlstm_init(jax.random.key(seed), D, DIMS)
    return p, carried(p, MLSTM_KEYS, tx.MLSTM, dtype)


def slstm_block(seed=0, dtype=torch.float32):
    p = jx.slstm_init(jax.random.key(seed), D, DIMS)
    return p, carried(p, SLSTM_KEYS, tx.SLSTM, dtype)


def models(dtype=torch.float32, **changes):
    jc = dataclasses.replace(jax_config(ARCH, "smoke"), dtype=DTYPES[dtype],
                             **changes)
    tc = dataclasses.replace(get_config(ARCH, "smoke"), dtype=dtype,
                             **changes)
    params = jtr.init_params(jax.random.key(0), jc)
    model = model_params_from_jax(jax.tree.map(np.asarray, params), tc,
                                  device="cpu")
    return jc, tc, params, model


# ----------------------------------------------------------------------
# mLSTM
# ----------------------------------------------------------------------

@pytest.mark.parametrize("s", [24, 80])
def test_mlstm_forward_matches_jax(s):
    """S = 24 is one block at chunk 32; S = 80 runs three query chunks, the
    last padded (the cumulative log f padded with its edge value)."""
    p, m = mlstm_block()
    x = np.random.default_rng(s).normal(0, 1, (2, s, D)).astype(np.float32)
    jout, jst = jax.jit(lambda p, x: jx.mlstm_forward(p, x, 32))(
        p, jnp.asarray(x))
    tout, tst = tx.mlstm_forward(m, torch.as_tensor(x), chunk=32)
    close(tout, jout)
    for k in ("c", "n", "m"):
        close(tst[k], jst[k])


def test_mlstm_state_from_seq_matches_jax():
    rng = np.random.default_rng(1)
    k, v = (rng.normal(0, 1, (2, 30, 4, 16)).astype(np.float32)
            for _ in range(2))
    log_f = -np.log1p(np.exp(-rng.normal(3, 1, (2, 30, 4)))) \
        .astype(np.float32)
    i_tilde = rng.normal(0, 1, (2, 30, 4)).astype(np.float32)
    want = jax.jit(jx._mlstm_state_from_seq)(
        *(jnp.asarray(a) for a in (k, v, log_f, i_tilde)))
    got = tx._mlstm_state_from_seq(*(torch.as_tensor(a)
                                     for a in (k, v, log_f, i_tilde)))
    for name in ("c", "n", "m"):
        close(got[name], want[name])


def test_mlstm_decode_matches_jax():
    p, m = mlstm_block(seed=1)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 1, D)).astype(np.float32)
    st = {"c": rng.normal(0, 1, (2, 4, 32, 32)),
          "n": rng.normal(0, 1, (2, 4, 32)), "m": rng.normal(0, 1, (2, 4))}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    jout, jst = jax.jit(jx.mlstm_decode)(
        p, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    tout, tst = tx.mlstm_decode(m, torch.as_tensor(x),
                                {k: torch.as_tensor(v) for k, v in st.items()})
    close(tout, jout)
    for k in ("c", "n", "m"):
        close(tst[k], jst[k])


def test_mlstm_chunked_grads_match_jax():
    """Gradients through the chunked form (three chunks, each under
    ``torch.utils.checkpoint`` with gradients on) against ``jax.grad`` of
    the reference's ``jax.checkpoint``-ed chunks, every leaf."""
    p, m = mlstm_block(seed=2)
    m.requires_grad_()
    x = np.random.default_rng(3).normal(0, 1, (2, 80, D)).astype(np.float32)
    w = np.random.default_rng(4).normal(0, 1, (2, 80, D)).astype(np.float32)

    def jloss(p):
        out, st = jx.mlstm_forward(p, jnp.asarray(x), 32)
        return jnp.sum(out * w) + jnp.sum(st["c"])

    jl, jg = jax.jit(jax.value_and_grad(jloss))(p)
    out, st = tx.mlstm_forward(m, torch.as_tensor(x), chunk=32)
    tl = torch.sum(out * torch.as_tensor(w)) + torch.sum(st["c"])
    grads = torch.autograd.grad(tl, [getattr(m, k) for k in MLSTM_KEYS])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k, g in zip(MLSTM_KEYS, grads):
        close_rel(g, jg[k])


# ----------------------------------------------------------------------
# sLSTM
# ----------------------------------------------------------------------

def test_slstm_forward_matches_jax():
    p, m = slstm_block()
    x = np.random.default_rng(5).normal(0, 1, (2, 40, D)).astype(np.float32)
    jout, jst = jax.jit(lambda p, x: jx.slstm_forward(p, x, DIMS.n_heads))(
        p, jnp.asarray(x))
    tout, tst = tx.slstm_forward(m, torch.as_tensor(x), DIMS.n_heads)
    close(tout, jout)
    for k in ("h", "c", "n", "m"):
        close(tst[k], jst[k])


def test_slstm_decode_matches_jax():
    p, m = slstm_block(seed=1)
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (2, 1, D)).astype(np.float32)
    st = {"h": rng.normal(0, 1, (2, D)), "c": rng.normal(0, 1, (2, D)),
          "n": rng.uniform(0.5, 2, (2, D)), "m": rng.normal(0, 1, (2, D))}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    jout, jst = jax.jit(lambda p, x, s: jx.slstm_decode(p, x, s, 4))(
        p, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()})
    tout, tst = tx.slstm_decode(m, torch.as_tensor(x),
                                {k: torch.as_tensor(v) for k, v in st.items()},
                                4)
    close(tout, jout)
    for k in ("h", "c", "n", "m"):
        close(tst[k], jst[k])


def test_zero_states_are_the_reference_s():
    """The full-sequence form starts at ``m = -1e30``; ``init_cache``'s
    zero state uses -30 (both as in the reference, where they differ)."""
    z = tx.slstm_zero_state(2, D, "cpu")
    np.testing.assert_array_equal(np32(z["m"]), np.asarray(
        jx.slstm_zero_state(2, D)["m"]))
    cache = ttr.init_cache(get_config(ARCH, "smoke"), 2, 8, device="cpu")
    jcache = jtr.init_cache(jax_config(ARCH, "smoke"), 2, 8)
    for t, j in zip(cache, jcache["blocks"]):
        assert sorted(t) == sorted(j)
        for k in t:
            assert t[k].dtype == torch.float32
            np.testing.assert_array_equal(np32(t[k]), np.asarray(j[k][0]))
    assert float(cache[1]["m"][0, 0]) == -30.0


@pytest.mark.parametrize("r_dtype", [torch.float32, torch.bfloat16])
def test_slstm_recurrence_follows_r_dtype(r_dtype):
    """bf16 activations: with ``r`` float32 (a serving model, as the JAX
    ``ServeEngine``'s float32 tree) ``h`` meets ``r`` in float32; with
    ``r`` bf16 (a train step's cast) ``h`` is rounded to bf16 first. Each
    against the reference at the same leaf dtypes, at the bf16 bound."""
    p, m = slstm_block(seed=2, dtype=torch.bfloat16)
    m.r.data = m.r.data.to(r_dtype)
    jp = dict(p, **{k: p[k].astype(jnp.bfloat16) for k in p
                    if k not in ("b", "r")})
    jp["r"] = p["r"].astype(DTYPES[r_dtype])
    x = np.random.default_rng(7).normal(0, 1, (2, 24, D))
    jout, jst = jax.jit(lambda p, x: jx.slstm_forward(p, x, 4))(
        jp, jnp.asarray(x, jnp.bfloat16))
    tout, tst = tx.slstm_forward(m, torch.as_tensor(x).to(torch.bfloat16), 4)
    close(tout, jout, rtol=0, atol=BF16_ATOL)
    close(tst["h"], jst["h"], rtol=0, atol=BF16_ATOL)


# ----------------------------------------------------------------------
# The model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_and_decode_match_jax(dtype):
    """S = 40 above chunk_q (32): prefill's chunked mLSTM; its logits and
    states, then 6 decode steps' logits and states."""
    jc, tc, params, model = models(dtype)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    jl, jcache = jax.jit(lambda p, t: jtr.prefill_forward(
        p, jc, {"tokens": t}, capacity=48))(params, jnp.asarray(toks))
    with torch.no_grad():
        tl, tcache = ttr.prefill_forward(model, tc, {"tokens": toks}, 48)
    tol = F32 if dtype == torch.float32 else dict(rtol=0, atol=BF16_ATOL)
    close(tl, jl, **tol)
    step = jax.jit(lambda p, c, t, pos: jtr.decode_step(p, jc, c, t, pos))
    for i in range(6):
        tok = rng.integers(0, jc.vocab_size, (2,)).astype(np.int32)
        jl, jcache = step(params, jcache, jnp.asarray(tok),
                          jnp.asarray(40 + i, jnp.int32))
        with torch.no_grad():
            tl, tcache = ttr.decode_step(model, tc, tcache,
                                         torch.as_tensor(tok), 40 + i)
        close(tl, jl, **tol)
    if dtype == torch.float32:
        for t, j in zip(tcache, jcache["blocks"]):
            for k in t:
                close(t[k], j[k][0])


@pytest.mark.parametrize("s", [64, 1024])
def test_train_forward_matches_jax(s):
    """tests/test_torch_train.py's loss check: the chunked mLSTM (chunk_q
    32) and the sLSTM loop over S = 64 and 1,024."""
    check_train_forward(ARCH, s)


def test_grads_match_jax():
    """tests/test_torch_train.py's gradient check (S = 96: three mLSTM
    chunks, each rematerialised), every leaf."""
    check_grads(ARCH)


def test_serving_model_keeps_the_reference_f32_leaves():
    """A bf16 serving model (built or carried across) keeps ``b_if``,
    ``b`` and ``r`` float32, and its prefill matches the reference's on
    the float32 tree (what the JAX ``ServeEngine`` serves) at the bf16
    bound; a master is float32 throughout."""
    jc, tc, params, model = models(torch.bfloat16)
    for built in (model, ttr.init_params(0, tc, device="cpu")):
        ml, sl = built.layers[0].mlstm, built.layers[1].slstm
        assert ml.b_if.dtype == sl.b.dtype == sl.r.dtype == torch.float32
        assert ml.wq.dtype == sl.w_in.dtype == torch.bfloat16
    master = ttr.init_params(0, tc, device="cpu", master=True)
    assert all(p.dtype == torch.float32 for p in master.parameters())
    toks = np.random.default_rng(10).integers(0, 512, (2, 24))
    jl, _ = jax.jit(lambda p, t: jtr.prefill_forward(
        p, jc, {"tokens": t}, capacity=32))(params, jnp.asarray(toks))
    with torch.no_grad():
        tl, _ = ttr.prefill_forward(model, tc, {"tokens": toks}, 32)
    close(tl, jl, rtol=0, atol=BF16_ATOL)


# ----------------------------------------------------------------------
# Depth: the 24-layer stack
# ----------------------------------------------------------------------

TESTS = Path(__file__).resolve().parent
SEEDS = (0, 1, 2)
# A fresh interpreter in which every ``float32`` either package names is
# float64 before either is imported, so that the recurrences' float32
# casts run in float64 too. It runs on one thread: beside the suite's
# workers, a pool of its own would contend with theirs.
FLOAT64 = """
import sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import torch
torch.set_num_threads(1)
jnp.float32 = jnp.float64
torch.float32 = torch.float64
torch.set_default_dtype(torch.float64)
sys.path.insert(0, {tests!r})
import test_torch_xlstm
print(test_torch_xlstm.float64_errors({layers}, {seeds}))
"""


def float64_errors(layers: int, seeds) -> str:
    """Loss and every gradient of the smoke config at ``layers`` layers,
    both packages in float64 from the same weights (the JAX init rounded
    to float32, which ``convert`` reads), for each seed of weights and
    data -> JSON [{"loss": relative difference, "grads": the largest over
    leaves of max |port - jax| / max |jax|}, ...]. Called in
    :data:`FLOAT64`'s interpreter."""
    jc = dataclasses.replace(jax_config(ARCH, "smoke"), n_layers=layers,
                             dtype=jnp.float64)
    tc = dataclasses.replace(get_config(ARCH, "smoke"), n_layers=layers,
                             dtype=torch.float64)
    grad = jax.jit(jax.value_and_grad(
        lambda p, bb: jtr.train_forward(p, jc, bb), has_aux=True))
    errs = []
    for seed in seeds:
        params = jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a, np.float32), jnp.float64),
            jtr.init_params(jax.random.key(seed), jc))
        b = next(batches(seed, tc.vocab_size, 2, 64, 1))
        batch = {"tokens": b.tokens, "targets": b.targets,
                 "mask": b.mask.astype(np.float64)}
        (jl, _), jg = grad(params, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        model = model_params_from_jax(jax.tree.map(np.asarray, params), tc,
                                      device="cpu", dtype=torch.float64)
        model.requires_grad_()
        tl, _ = ttr.train_forward(model, tc, {k: torch.as_tensor(v)
                                              for k, v in batch.items()})
        names = [n for n, _ in model.named_parameters()]
        tg = torch.autograd.grad(tl, list(model.parameters()))
        want = jax_leaves(jg)
        got = as_jax_leaves(model, dict(zip(names, tg)))
        assert {str(a.dtype) for a in (*want.values(), *got.values())} \
            == {"float64"}
        errs.append({
            "loss": abs(float(tl.detach()) - float(jl)) / abs(float(jl)),
            "grads": max(float(np.abs(got[k] - want[k]).max()
                               / np.abs(want[k]).max()) for k in want)})
    return json.dumps(errs)


@pytest.fixture(scope="module")
def deep_float64_errors():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               PYTHONPATH=os.pathsep.join(
                   [str(TESTS.parent / "src"),
                    os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-c", FLOAT64.format(tests=str(TESTS), layers=24,
                                              seeds=SEEDS)],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("seed", SEEDS)
def test_deep_stack_matches_jax_in_float64(deep_float64_errors, seed):
    """xlstm-350m's 24 layers at smoke width. The stack's gradient norm
    grows about 1.4x a layer, and rounding with it, so in float32 the
    two packages' gradients part there. In float64 the port's loss and
    every gradient leaf follow the reference's (largest over the three
    seeds, on one thread or eight: loss 2.4e-14, gradients 1.7e-9)."""
    err = deep_float64_errors[SEEDS.index(seed)]
    assert err["loss"] <= 1e-12, err
    assert err["grads"] <= 1e-8, err


def train_steps(width: str, layers: int, b: int, s: int, steps: int):
    """Both packages' ``make_train_step`` in float32 from the JAX init
    (seed 0) at ``width`` ("full" or "smoke") cut to ``layers`` layers, on
    ``batches(0, vocab, b, s, steps)``, lr 3e-4 with warmup 1 -> (JAX rows,
    port rows), each row (loss, grad_norm)."""
    jc = dataclasses.replace(jax_config(ARCH, width), n_layers=layers,
                             dtype=jnp.float32)
    tc = dataclasses.replace(get_config(ARCH, width), n_layers=layers,
                             dtype=torch.float32)
    data = list(batches(0, tc.vocab_size, b, s, steps))
    params = jtr.init_params(jax.random.key(0), jc)
    model = model_params_from_jax(jax.tree.map(np.asarray, params), tc,
                                  device="cpu", dtype=torch.float32)
    model.requires_grad_()
    opt = dict(lr=3e-4, warmup_steps=1, total_steps=steps)
    step = tsteps.make_train_step(tc, AdamWConfig(**opt))
    state = init_opt_state(model)
    port = []
    for t in data:
        r = step(model, state, {"tokens": torch.as_tensor(t.tokens),
                                "targets": torch.as_tensor(t.targets),
                                "mask": torch.as_tensor(t.mask)})
        port.append((r["loss"], r["grad_norm"]))
    del model, state
    jstep = jax.jit(jsteps.make_train_step(jc, jadam.AdamWConfig(**opt)))
    jstate = jadam.init_opt_state(params)
    ref = []
    for t in data:
        params, jstate, m = jstep(params, jstate, {
            "tokens": jnp.asarray(t.tokens), "targets": jnp.asarray(t.targets),
            "mask": jnp.asarray(t.mask)})
        ref.append((float(m["loss"]), float(m["grad_norm"])))
    return ref, port


if __name__ == "__main__":
    cli = argparse.ArgumentParser(description=train_steps.__doc__)
    cli.add_argument("--width", choices=("full", "smoke"), default="smoke")
    cli.add_argument("--layers", type=int, nargs="+", default=[2, 24])
    cli.add_argument("--batch", type=int, default=2)
    cli.add_argument("--seq", type=int, default=64)
    cli.add_argument("--steps", type=int, default=10)
    a = cli.parse_args()
    for n in a.layers:
        ref, port = train_steps(a.width, n, a.batch, a.seq, a.steps)
        for who, rows in (("jax", ref), ("port", port)):
            print(f"{a.width} width, {n} layers, B = {a.batch}, S = "
                  f"{a.seq}, {who}: loss " + " ".join(
                      f"{x:.6f}" for x, _ in rows) + "; grad_norm "
                  + " ".join(f"{g:.4g}" for _, g in rows), flush=True)
