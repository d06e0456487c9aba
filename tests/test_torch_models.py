"""The port's transformer substrate (``repro_torch.models``) against the JAX
package's on the same numpy inputs and the same weights, at the smoke
configs on the CPU.

The weights are the JAX package's ``init_params``, carried across by
``convert.model_params_from_jax``. Tolerances:

- float32 (``dataclasses.replace(cfg, dtype=...)`` on both sides): rtol
  and atol 1e-5 for every block, attention path, prefill logits and cache
  and 8 decode steps (measured up to 1.9e-6 on logits of order 1);
- bfloat16, the configs' own dtype: atol 5e-2 on logits of order 1
  (measured 1.2e-2 to 1.5e-2): the two frameworks round bf16 products
  at other places (XLA may keep a fused op in f32 where torch rounds);
  the cache, written before any such difference reaches it in layer 0,
  within one bf16 ulp (atol 1e-2 at these magnitudes).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import transformer as jtr
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttr

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_LOGITS_ATOL = 5e-2
ARCHS = ["internlm2-1.8b", "gemma-7b", "yi-6b", "internvl2-26b"]
MOE_ARCHS = ["deepseek-moe-16b", "mixtral-8x7b"]


def np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, dtype=np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(np32(got), np32(want), **(tol or F32))


def configs(arch, dtype=torch.float32):
    """The smoke config of ``arch`` in both packages, in ``dtype``; yi-6b
    takes its full config's rope_theta (5e6) so RoPE's base is exercised."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jc = dataclasses.replace(jax_config(arch, "smoke"), dtype=jdt)
    tc = dataclasses.replace(get_config(arch, "smoke"), dtype=dtype)
    if arch == "yi-6b":
        theta = jax_config(arch, "full").rope_theta
        jc = dataclasses.replace(jc, rope_theta=theta)
        tc = dataclasses.replace(tc, rope_theta=theta)
    return jc, tc


def attn_params(d, dims, seed=0):
    """JAX attention params and the same matrices as a port module."""
    p = jattn.attn_init(jax.random.key(seed), d, dims)
    return p, tattn.Attention(*(torch.as_tensor(np.array(p[k]))
                                for k in ("wq", "wk", "wv", "wo")))


# ----------------------------------------------------------------------
# Blocks
# ----------------------------------------------------------------------

def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (3, 7, 64)).astype(np.float32)
    scale = rng.normal(0, 0.5, (64,)).astype(np.float32)
    close(tcommon.rms_norm(torch.as_tensor(x), torch.as_tensor(scale)),
          jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale)))


@pytest.mark.parametrize("theta", [1e4, 5e6])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 9, 4, 32)).astype(np.float32)
    pos = np.arange(100, 109, dtype=np.float32)
    jc, js = jcommon.make_rope(jnp.asarray(pos), 32, theta)
    tc, ts = tcommon.make_rope(torch.as_tensor(pos), 32, theta)
    close(tc, jc)
    close(ts, js)
    close(tcommon.apply_rope(torch.as_tensor(x), tc, ts),
          jcommon.apply_rope(jnp.asarray(x), jc, js))


@pytest.mark.parametrize("name", ["silu", "gelu", "relu", "tanh"])
def test_activation(name):
    """gelu is the tanh approximation, as ``jax.nn.gelu``'s default."""
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    close(tcommon.activation_fn(name)(torch.as_tensor(x)),
          jcommon.activation_fn(name)(jnp.asarray(x)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("gated,act", [(True, "silu"), (True, "gelu"),
                                       (False, "relu")])
def test_mlp(gated, act):
    p = jmlp.mlp_init(jax.random.key(2), 64, 128, gated)
    mod = tmlp.MLP(torch.as_tensor(np.array(p["w_up"])),
                   torch.as_tensor(np.array(p["w_down"])),
                   torch.as_tensor(np.array(p["w_gate"])) if gated
                   else None)
    x = np.random.default_rng(3).normal(0, 1, (2, 5, 64)).astype(np.float32)
    close(tmlp.mlp_forward(mod, torch.as_tensor(x), act),
          jmlp.mlp_forward(p, jnp.asarray(x), act))


# ----------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,chunk", [
    (True, None, 256),      # one chunk
    (True, 16, 256),        # sliding window
    (True, None, 16),       # chunk < S, S a chunk multiple
    (True, 8, 12),          # chunk < S with padded queries, windowed
    (False, None, 16),      # bidirectional, chunked
])
def test_attention_forward(causal, window, chunk):
    d, dims = 64, jattn.AttnDims(4, 2, 16, 10000.0, window)
    jp, tp = attn_params(d, dims)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 48, d)).astype(np.float32)
    pos = np.arange(48, dtype=np.float32)
    jo, (jk, jv) = jattn.attention_forward(
        jp, jnp.asarray(x), jnp.asarray(pos), dims, causal=causal,
        chunk=chunk, return_kv=True)
    to, (tk, tv) = tattn.attention_forward(
        tp, torch.as_tensor(x), torch.as_tensor(pos),
        tattn.AttnDims(*dims), causal=causal, chunk=chunk, return_kv=True)
    close(to, jo)
    close(tk, jk)
    close(tv, jv)


@pytest.mark.parametrize("ring,window,capacity", [
    (False, None, 64),      # full cache
    (False, 12, 64),        # full cache, sliding-window attention
    (True, None, 16),       # ring buffer of the window's size
    (True, 8, 16),          # ring buffer wider than the window
])
def test_attention_decode(ring, window, capacity):
    """24 decode steps from a random cache; in ring mode the positions
    wrap the buffer; every step's output and the written cache match."""
    d, dims = 64, jattn.AttnDims(4, 2, 16, 10000.0, window)
    jp, tp = attn_params(d, dims, seed=5)
    rng = np.random.default_rng(6)
    ck = rng.normal(0, 1, (2, capacity, 2, 16)).astype(np.float32)
    cv = rng.normal(0, 1, (2, capacity, 2, 16)).astype(np.float32)
    jk, jv = jnp.asarray(ck), jnp.asarray(cv)
    tk, tv = torch.as_tensor(ck.copy()), torch.as_tensor(cv.copy())
    start = 10
    for i in range(24):
        x = rng.normal(0, 1, (2, 1, d)).astype(np.float32)
        pos = start + i
        jo, jk, jv = jattn.attention_decode(
            jp, jnp.asarray(x), jnp.asarray(pos, jnp.int32), jk, jv, dims,
            ring=ring, window=window)
        to, tk2, tv2 = tattn.attention_decode(
            tp, torch.as_tensor(x), pos, tk, tv, tattn.AttnDims(*dims),
            ring=ring, window=window)
        assert tk2 is tk and tv2 is tv      # written in place
        close(to, jo)
    close(tk, jk)
    close(tv, jv)


# ----------------------------------------------------------------------
# Whole model: prefill, cache, decode
# ----------------------------------------------------------------------

def models(arch, dtype=torch.float32):
    jc, tc = configs(arch, dtype)
    params = jtr.init_params(jax.random.key(0), jc)
    model = model_params_from_jax(jax.tree.map(np.asarray, params), tc,
                                  device="cpu")
    return jc, tc, params, model


def make_batch(cfg, rng, b, s):
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
             .astype(np.int32)}
    if cfg.frontend == "vision":
        batch["prefix"] = rng.normal(0, 0.02, (b, cfg.n_prefix, cfg.d_model)
                                     ).astype(np.float32)
    return batch


def jax_cache_layers(cache, cfg):
    """The JAX cache as one {"k", "v"} dict per layer in layer order."""
    out = list(cache["head"])
    for g in range(cfg.n_groups):
        for stacked in cache["blocks"]:
            out.append({k: stacked[k][g] for k in ("k", "v")})
    return out + list(cache["tail"])


def run_both(arch, dtype, steps=8, b=2, s=40, capacity=56):
    jc, tc, params, model = models(arch, dtype)
    rng = np.random.default_rng(7)
    batch = make_batch(jc, rng, b, s)
    off = jc.n_prefix if jc.frontend == "vision" else 0
    cap = capacity + off
    jl, jcache = jax.jit(lambda p, bt: jtr.prefill_forward(
        p, jc, bt, capacity=cap))(params, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    tl, tcache = ttr.prefill_forward(model, tc, batch, capacity=cap)
    logits = [(tl, jl)]
    # decode writes the port's cache in place: keep the prefill's a copy
    caches = [([{k: t.clone() for k, t in st.items()} for st in tcache],
               jax_cache_layers(jcache, jc))]
    step = jax.jit(lambda p, c, t, pos: jtr.decode_step(p, jc, c, t, pos))
    for i in range(steps):
        tok = rng.integers(0, jc.vocab_size, (b,)).astype(np.int32)
        jl, jcache = step(params, jcache, jnp.asarray(tok),
                          jnp.asarray(off + s + i, jnp.int32))
        tl, tcache = ttr.decode_step(model, tc, tcache, torch.as_tensor(tok),
                                     off + s + i)
        logits.append((tl, jl))
    caches.append((tcache, jax_cache_layers(jcache, jc)))
    return logits, caches


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS)
def test_prefill_and_decode_f32(arch):
    """internlm2 (GQA), gemma (embed_scale, GeGLU, MHA), yi (rope_theta
    5e6), internvl2 (the vision prefix), deepseek-moe (a dense head layer,
    then MoE with a shared expert) and mixtral (MoE over sliding-window
    layers), at the configs' own capacity factor (both packages drop the
    same choices): prefill logits and cache, then 8 decode steps' logits
    and the cache they wrote."""
    logits, caches = run_both(arch, torch.float32)
    for tl, jl in logits:
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        close(tl, jl)
    for tcache, jcache in caches:
        assert len(tcache) == len(jcache)
        for t, j in zip(tcache, jcache):
            close(t["k"], j["k"])
            close(t["v"], j["v"])


def test_prefill_and_decode_bf16():
    """The config's own dtype (bf16) at the bound in the module docstring."""
    logits, caches = run_both("internlm2-1.8b", torch.bfloat16)
    for tl, jl in logits:
        close(tl, jl, rtol=0, atol=BF16_LOGITS_ATOL)
    t0, j0 = caches[0][0][0], caches[0][1][0]
    assert t0["k"].dtype == torch.bfloat16
    close(t0["k"], j0["k"], rtol=0, atol=1e-2)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_bf16(arch):
    """The MoE configs in their own dtype (bf16) at the bound in the module
    docstring."""
    logits, caches = run_both(arch, torch.bfloat16)
    for tl, jl in logits:
        close(tl, jl, rtol=0, atol=BF16_LOGITS_ATOL)
    t0, j0 = caches[0][0][0], caches[0][1][0]
    close(t0["k"], j0["k"], rtol=0, atol=1e-2)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_prefill_drop_free(arch):
    """The port alone: decode step i's logits against prefill's on the
    prompt extended by the same tokens (f32, 1e-5). Capacity couples a
    group's tokens, so the two agree only where no choice can drop: at
    capacity factor ``n_experts`` (tests/test_archs.py's way)."""
    _, tc = configs(arch)
    tc = dataclasses.replace(tc, moe=tc.moe._replace(
        capacity_factor=float(tc.moe.n_experts)))
    model = ttr.init_params(0, tc, device="cpu")
    rng = np.random.default_rng(10)
    prompt = rng.integers(0, tc.vocab_size, (3, 20))
    forced = rng.integers(0, tc.vocab_size, (3, 6))
    _, cache = ttr.prefill_forward(model, tc, {"tokens": prompt}, 32)
    for i in range(6):
        got, cache = ttr.decode_step(model, tc, cache, forced[:, i], 20 + i)
        want, _ = ttr.prefill_forward(model, tc, {"tokens": np.concatenate(
            [prompt, forced[:, :i + 1]], 1)}, 32)
        close(got, want)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m",
                                  "seamless-m4t-medium"])
def test_decode_matches_full_forward(arch):
    """tests/test_archs.py's check on the families ported last: prefill S
    = 40 tokens (past recurrentgemma's 32-token local window, above
    xlstm's chunk_q 32; seamless with its frames), decode token S,
    against the full forward's last logits over S + 1 tokens at the
    reference's own bound, 2e-3 (xlstm's parallel-form and recurrent
    stabilisers differ in both packages)."""
    _, tc = configs(arch)
    model = ttr.init_params(0, tc, device="cpu")
    rng = np.random.default_rng(11)
    full = {"tokens": rng.integers(0, tc.vocab_size, (2, 41))}
    if tc.n_enc_layers:
        full["src_embeds"] = rng.normal(0, 1, (2, 10, tc.d_model)
                                        ).astype(np.float32)
    prompt = dict(full, tokens=full["tokens"][:, :40])
    with torch.no_grad():
        _, cache = ttr.prefill_forward(model, tc, prompt, 41)
        got, _ = ttr.decode_step(model, tc, cache, full["tokens"][:, 40], 40)
        want, _ = ttr.prefill_forward(model, tc, full, 41)
    close(got, want, rtol=2e-3, atol=2e-3)


def test_prefill_capacity_below_length_and_ring():
    """A prefill longer than the cache keeps the last C positions, rolled
    for a ring so that position p sits at p % C, as in the reference;
    ring decode from there matches."""
    jc, tc, params, model = models("internlm2-1.8b")
    jc = dataclasses.replace(jc, pattern=("swa",), window=16)
    tc = dataclasses.replace(tc, pattern=("swa",), window=16)
    rng = np.random.default_rng(8)
    batch = make_batch(jc, rng, 2, 37)
    jl, jcache = jtr.prefill_forward(params, jc, {"tokens": jnp.asarray(
        batch["tokens"])}, capacity=16, ring=True)
    tl, tcache = ttr.prefill_forward(model, tc, batch, capacity=16, ring=True)
    close(tl, jl)
    for t, j in zip(tcache, jax_cache_layers(jcache, jc)):
        close(t["k"], j["k"])
    for i in range(20):
        tok = rng.integers(0, jc.vocab_size, (2,)).astype(np.int32)
        jl, jcache = jtr.decode_step(params, jc, jcache, jnp.asarray(tok),
                                     jnp.asarray(37 + i, jnp.int32), ring=True)
        tl, tcache = ttr.decode_step(model, tc, tcache, torch.as_tensor(tok),
                                     37 + i, ring=True)
        close(tl, jl)


def test_init_params_and_cache_layout():
    """A model drawn from a seed: matrices in the compute dtype, norms in
    float32, the same weights from the same seed; the zero cache is one
    (B, C, KV, hd) pair per layer."""
    cfg = get_config("internlm2-1.8b", "smoke")
    a = ttr.init_params(0, cfg, device="cpu")
    b = ttr.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert a.embed.dtype == torch.bfloat16 and a.layers[0].ln1.dtype == \
        torch.float32
    assert a.layers[0].attn.wq.shape == (cfg.d_model, cfg.n_heads, cfg.hd)
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert not any(p.requires_grad for p in a.parameters())
    cache = ttr.init_cache(cfg, 3, 20, device="cpu")
    assert len(cache) == cfg.n_layers
    assert cache[0]["k"].shape == (3, 20, cfg.n_kv_heads, cfg.hd)
    assert cache[0]["v"].dtype == cfg.dtype


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-moe-16b"])
def test_init_params_master(arch):
    """``master=True``: the same draw as the serving model, every leaf
    float32 and trainable; the serving model is its matrices cast to the
    compute dtype."""
    cfg = get_config(arch, "smoke")
    serving = ttr.init_params(0, cfg, device="cpu")
    master = ttr.init_params(0, cfg, device="cpu", master=True)
    pairs = list(zip(serving.parameters(), master.parameters()))
    assert len(pairs) == len(list(master.parameters()))
    for s, m in pairs:
        assert m.dtype == torch.float32 and m.requires_grad
        assert not s.requires_grad
        assert torch.equal(s, m.detach().to(s.dtype))


# ----------------------------------------------------------------------
# Unknown layer types
# ----------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["init", "forward", "decode"])
def test_unknown_layer_type_raises_value_error(entry):
    """A layer type the JAX package rejects (``ValueError`` in its
    ``_layer_init``, ``_decode_layer`` and ``_zero_state``) is refused by
    the port's entry points alike."""
    cfg = get_config("internlm2-1.8b", "smoke")
    bad = dataclasses.replace(cfg, pattern=("attn", "bogus"))
    model = ttr.init_params(0, cfg, device="cpu")
    toks = np.zeros((1, 4), np.int32)
    if entry == "init":
        with pytest.raises(ValueError, match="bogus"):
            jtr.init_params(jax.random.key(0), dataclasses.replace(
                jax_config("internlm2-1.8b", "smoke"),
                pattern=("attn", "bogus")))
    with pytest.raises(ValueError, match="bogus"):
        if entry == "init":
            ttr.init_params(0, bad, device="cpu")
        elif entry == "forward":
            ttr.train_forward(model, bad, {"tokens": toks, "targets": toks,
                                           "mask": np.ones((1, 4))})
        else:
            ttr.decode_step(model, bad, ttr.init_cache(cfg, 1, 8,
                                                       device="cpu"),
                            toks[:, 0], 0)
