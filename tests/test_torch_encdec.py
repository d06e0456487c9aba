"""The port's encoder-decoder (seamless-m4t-medium: a bidirectional encoder
over frame embeddings, decoder layers with cross-attention) against the
JAX package's on the same numpy inputs and the same weights, at the smoke
config on the CPU; its trainer's data and its monitor; and checkpoints of
the three families ported last crossing between the packages both ways.

Tolerances: float32 rtol/atol 1e-5; bfloat16 atol 5e-2 on logits of order
1 (tests/test_torch_models.py); monitor scores under the same global GMM
rtol/atol 2e-4 (the kernels' bound, tests/test_kernels.py). Prefill ->
decode against the full forward: tests/test_torch_models.py.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_config as jax_config
from repro.launch import train as jtrain
from repro.models import transformer as jtr
from repro.monitor import FedGMMMonitor as JaxMonitor
from repro.monitor import MonitorConfig as JaxMonitorConfig
from repro.monitor import extract_features as jax_extract
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import (model_params_from_jax, model_params_to_jax,
                                 monitor_from_jax)
from repro_torch.launch import train as train_mod
from repro_torch.models import transformer as ttr
from repro_torch.monitor import MonitorConfig, extract_features
from test_torch_train import check_grads, check_train_forward

ARCH = "seamless-m4t-medium"
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 5e-2
DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, dtype=np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(np32(got), np32(want), **(tol or F32))


def models(arch=ARCH, dtype=torch.float32, seed=0):
    jc = dataclasses.replace(jax_config(arch, "smoke"), dtype=DTYPES[dtype])
    tc = dataclasses.replace(get_config(arch, "smoke"), dtype=dtype)
    params = jtr.init_params(jax.random.key(seed), jc)
    model = model_params_from_jax(jax.tree.map(np.asarray, params), tc,
                                  device="cpu")
    return jc, tc, params, model


def make_batch(cfg, rng, b, s):
    """Tokens and frame embeddings at ``s // src_ratio``."""
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
            .astype(np.int32),
            "src_embeds": rng.normal(0, 1, (b, s // cfg.src_ratio,
                                            cfg.d_model)).astype(np.float32)}


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def jax_leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_encoder_matches_jax():
    jc, tc, params, model = models()
    src = np.random.default_rng(0).normal(0, 1, (2, 12, jc.d_model)) \
        .astype(np.float32)
    want = jax.jit(lambda p, s: jtr._run_encoder(p, jc, s))(
        params, jnp.asarray(src))
    with torch.no_grad():
        got = ttr._run_encoder(model, tc, src)
    close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_and_decode_match_jax(dtype):
    """Prefill logits and cache (self-attention k/v and the cross-attention
    memory xk/xv of every decoder layer; in bf16 layer 0's k, written
    before the frameworks' rounding differences reach it, within one bf16
    ulp, as tests/test_torch_models.py holds it), then 6 decode steps."""
    jc, tc, params, model = models(dtype=dtype)
    rng = np.random.default_rng(1)
    batch = make_batch(jc, rng, 2, 40)
    jl, jcache = jax.jit(lambda p, b: jtr.prefill_forward(
        p, jc, b, capacity=48))(params, jbatch(batch))
    with torch.no_grad():
        tl, tcache = ttr.prefill_forward(model, tc, batch, 48)
    tol = F32 if dtype == torch.float32 else dict(rtol=0, atol=BF16_ATOL)
    close(tl, jl, **tol)
    jlayers = [{k: v[g] for k, v in jcache["blocks"][0].items()}
               for g in range(jc.n_groups)]
    for t, j in zip(tcache, jlayers):
        assert sorted(t) == ["k", "v", "xk", "xv"] == sorted(j)
        assert t["xk"].shape == (2, 10, jc.n_kv_heads, jc.hd)
        for k in t:
            if dtype == torch.float32:
                close(t[k], j[k])
    close(tcache[0]["k"], jlayers[0]["k"], rtol=0, atol=1e-2)
    step = jax.jit(lambda p, c, t, pos: jtr.decode_step(p, jc, c, t, pos))
    for i in range(6):
        tok = rng.integers(0, jc.vocab_size, (2,)).astype(np.int32)
        jl, jcache = step(params, jcache, jnp.asarray(tok),
                          jnp.asarray(40 + i, jnp.int32))
        with torch.no_grad():
            tl, tcache = ttr.decode_step(model, tc, tcache,
                                         torch.as_tensor(tok), 40 + i)
        close(tl, jl, **tol)


def test_init_cache_is_the_reference_zero_state():
    tc, jc = get_config(ARCH, "smoke"), jax_config(ARCH, "smoke")
    cache = ttr.init_cache(tc, 3, 20, device="cpu", enc_len=7)
    jcache = jtr.init_cache(jc, 3, 20, enc_len=7)["blocks"][0]
    assert len(cache) == jc.n_layers
    for st in cache:
        assert sorted(st) == sorted(jcache)
        for k in st:
            assert st[k].shape == jcache[k].shape[1:]
            assert st[k].dtype == torch.bfloat16
            assert not bool(st[k].any())
    assert cache[0]["xk"].data_ptr() != cache[0]["xv"].data_ptr()


@pytest.mark.parametrize("s", [64, 1024])
def test_train_forward_matches_jax(s):
    """tests/test_torch_train.py's loss check (the frames at ``s // 4``):
    one loss block at S = 64, two chunks at S = 1024."""
    check_train_forward(ARCH, s)


def test_grads_match_jax():
    """tests/test_torch_train.py's gradient check, the encoder's leaves
    included."""
    check_grads(ARCH)


def test_train_forward_and_grads_need_src_embeds():
    """The loss with ``src_embeds`` against the reference's (f32 1e-5);
    the encoder's leaves take gradients."""
    jc, tc, params, model = models()
    rng = np.random.default_rng(3)
    batch = make_batch(jc, rng, 2, 32)
    batch["targets"] = rng.integers(0, jc.vocab_size, (2, 32)) \
        .astype(np.int32)
    batch["mask"] = np.ones((2, 32), np.float32)
    jl, _ = jax.jit(lambda p, b: jtr.train_forward(p, jc, b))(
        params, jbatch(batch))
    model.requires_grad_()
    tl, _ = ttr.train_forward(model, tc, batch)
    close(tl, jl)
    grads = torch.autograd.grad(tl, list(model.encoder.parameters()))
    assert all(float(g.abs().max()) > 0 for g in grads)
    with pytest.raises(KeyError, match="src_embeds"):
        ttr.train_forward(model, tc, {k: v for k, v in batch.items()
                                      if k != "src_embeds"})


# ----------------------------------------------------------------------
# The trainer and the monitor
# ----------------------------------------------------------------------

def test_trainer_src_embeds_equal_the_jax_trainer_s(monkeypatch):
    """Both trainers' batches recorded at the step: tokens, targets, mask
    and ``src_embeds`` (drawn after the vision prefix from the same numpy
    ``rng``) bit for bit."""
    seen = {"jax": [], "port": []}

    def jax_step(cfg, opt):
        def step(params, opt_state, batch):
            seen["jax"].append({k: np32(v) for k, v in batch.items()})
            return params, opt_state, {"loss": 0.0, "lr": 0.0,
                                       "grad_norm": 0.0}
        return step

    def port_step(cfg, opt):
        def step(model, opt_state, batch):
            seen["port"].append({k: np32(v) for k, v in batch.items()})
            return {"loss": 0.0, "lr": 0.0, "grad_norm": 0.0}
        return step

    monkeypatch.setattr(jtrain, "make_train_step", jax_step)
    monkeypatch.setattr(jtrain, "jax", types.SimpleNamespace(
        jit=lambda f, **_: f, random=jax.random))
    monkeypatch.setattr(train_mod, "make_train_step", port_step)
    jtrain.train(ARCH, "smoke", steps=3, batch_size=2, seq_len=32,
                 log_every=100)
    train_mod.train(ARCH, "smoke", steps=3, batch_size=2, seq_len=32,
                    log_every=100, device="cpu")
    assert len(seen["jax"]) == len(seen["port"]) == 3
    for j, t in zip(seen["jax"], seen["port"]):
        assert sorted(j) == sorted(t) == ["mask", "src_embeds", "targets",
                                          "tokens"]
        assert t["src_embeds"].shape == (2, 8, 256)
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])


def test_trainer_runs_the_encoder_decoder():
    """Three real steps: finite losses, and the encoder's leaves moved
    from their draw (its gradients reach the masters)."""
    model, losses = train_mod.train(ARCH, "smoke", steps=3, batch_size=2,
                                    seq_len=16, log_every=100, device="cpu")
    assert np.isfinite(losses).all() and len(losses) == 3
    start = ttr.init_params(0, get_config(ARCH, "smoke"), device="cpu",
                            master=True)
    assert all(not torch.equal(p, q) for p, q in zip(
        model.encoder.parameters(), start.encoder.parameters()))


def test_monitor_features_and_scores_match_jax():
    """``extract_features`` with ``src_embeds`` (f32 1e-5) and the scores
    under the JAX monitor's global GMM (2e-4)."""
    jc, tc, params, model = models()
    rng = np.random.default_rng(4)
    small = dict(k_local=2, k_global=3, h=30)
    jmon = JaxMonitor(jc, JaxMonitorConfig(**small))
    for cid in range(2):
        jmon.observe(cid, params, jbatch(make_batch(jc, rng, 8, 16)))
    g = jmon.aggregate()
    mon = monitor_from_jax(tc, MonitorConfig(**small), np.asarray(jmon.proj),
                           tuple(np.asarray(a) for a in
                                 (g.weights, g.means, g.covs)), device="cpu")
    batch = make_batch(jc, rng, 8, 16)
    with torch.no_grad():
        got = extract_features(model, tc, batch, mon.proj)
        scores = mon.score(model, batch)
    close(got, jax_extract(params, jc, jbatch(batch), jmon.proj))
    np.testing.assert_allclose(scores, jmon.score(params, jbatch(batch)),
                               rtol=2e-4, atol=2e-4)


# ----------------------------------------------------------------------
# Checkpoints across the packages
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m", ARCH])
def test_checkpoints_cross_both_ways(arch, tmp_path):
    """A port model's checkpoint restores into the JAX ``init_params``
    tree, and a JAX tree's into the port's layout, leaf for leaf; the JAX
    prefill on the first gives the port's logits (f32 1e-5)."""
    jc, tc, params, model = models(arch, seed=1)
    save_checkpoint(str(tmp_path / "port"), model_params_to_jax(model))
    restored, _ = jax_load_checkpoint(str(tmp_path / "port"),
                                      jtr.init_params(jax.random.key(2), jc))
    want = jax_leaves(params)
    got = jax_leaves(restored)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    batch = make_batch(jc, np.random.default_rng(5), 2, 24)
    if not jc.n_enc_layers:
        del batch["src_embeds"]
    jl, _ = jax.jit(lambda p, b: jtr.prefill_forward(p, jc, b, 32))(
        restored, jbatch(batch))
    with torch.no_grad():
        tl, _ = ttr.prefill_forward(model, tc, batch, 32)
    close(tl, jl)

    jax_save_checkpoint(str(tmp_path / "jax"), params, {"step": 0})
    like = model_params_to_jax(ttr.init_params(0, tc, device="cpu",
                                               master=True))
    tree, _ = load_checkpoint(str(tmp_path / "jax"), like)
    back = model_params_from_jax(tree, tc, device="cpu")
    for (n, p), q in zip(back.named_parameters(), model.parameters()):
        assert torch.equal(p, q), n
