"""The port's RG-LRU block (``repro_torch.models.rglru``) and the
recurrentgemma-9b family against the JAX package's on the same numpy
inputs and the same weights, at the smoke config on the CPU.

The weights are the JAX package's, carried across by
``convert.model_params_from_jax`` (a block's by hand). Tolerances:

- the scan: bit for bit against ``jax.lax.associative_scan`` (the port
  runs the same odd-even recursion over the same ``combine``);
- float32 block and model outputs, states and logits: rtol/atol 1e-5;
- bfloat16 (the config's dtype): atol 5e-2 on logits of order 1
  (tests/test_torch_models.py's bound);
- prefill -> decode against the full forward and the JAX engine's greedy
  tokens: tests/test_torch_models.py and tests/test_torch_launch_serve.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import rglru as jrglru
from repro.models import transformer as jtr
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as ttr
from test_torch_train import check_grads, check_train_forward

ARCH = "recurrentgemma-9b"
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 5e-2
DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, dtype=np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(np32(got), np32(want), **(tol or F32))


def block(d=48, dr=40, seed=0, dtype=torch.float32):
    """JAX RG-LRU params (float32, as the reference inits them) and the
    same leaves as a port module, matrices in ``dtype``."""
    p = jrglru.rglru_init(jax.random.key(seed), d, jrglru.RGLRUDims(dr))
    leaves = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    keep = {"log_lambda"}
    return p, trglru.RGLRU(*(leaves[k] if k in keep else leaves[k].to(dtype)
                             for k in ("w_gate_in", "w_rec_in", "conv_w",
                                       "conv_b", "w_r", "w_i", "log_lambda",
                                       "w_out")))


def models(dtype=torch.float32, **changes):
    jc = dataclasses.replace(jax_config(ARCH, "smoke"), dtype=DTYPES[dtype],
                             **changes)
    tc = dataclasses.replace(get_config(ARCH, "smoke"), dtype=dtype,
                             **changes)
    params = jtr.init_params(jax.random.key(0), jc)
    model = model_params_from_jax(jax.tree.map(np.asarray, params), tc,
                                  device="cpu")
    return jc, tc, params, model


def jax_cache_layers(cache, cfg):
    """The JAX cache as one dict per layer in layer order."""
    out = list(cache["head"])
    for g in range(cfg.n_groups):
        for stacked in cache["blocks"]:
            out.append({k: v[g] for k, v in stacked.items()})
    return out + list(cache["tail"])


# ----------------------------------------------------------------------
# The scan and the block
# ----------------------------------------------------------------------

def jax_scan(a, b):
    return jax.lax.associative_scan(
        lambda e1, e2: (e1[0] * e2[0], e2[0] * e1[1] + e2[1]),
        (jnp.asarray(a), jnp.asarray(b)), axis=1)


def decays(rng, n):
    """Decays in RG-LRU's range (``a = lam ** r``, lam in (0.9, 0.999)) and
    inputs, (2, n, 5) each."""
    return (rng.uniform(0.9, 1.0, (2, n, 5)).astype(np.float32),
            rng.normal(0, 1, (2, n, 5)).astype(np.float32))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 33])
def test_scan_bits_equal_eager_jax(n):
    """Op by op, the reference's scan and the port's round alike."""
    a, b = decays(np.random.default_rng(n), n)
    ja, jh = jax_scan(a, b)
    ta, th = trglru.associative_scan(trglru._combine, (torch.as_tensor(a),
                                                       torch.as_tensor(b)),
                                     axis=1)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("n", [64, 333, 2048])
def test_scan_matches_jitted_jax(n):
    """Under ``jax.jit`` (as the reference's steps run) XLA fuses ``a2 * b1
    + b2`` into one FMA, so the two part by rounding: 1.9e-6 at most over
    three seeds at these lengths, held at 1e-5."""
    a, b = decays(np.random.default_rng(n), n)
    ja, jh = jax.jit(jax_scan)(a, b)
    _, th = trglru.associative_scan(trglru._combine, (torch.as_tensor(a),
                                                      torch.as_tensor(b)),
                                    axis=1)
    close(th, jh)


def test_scan_is_the_recurrence():
    """The scan's h against the sequential loop ``h = a h + b`` in float64
    (rtol/atol 1e-5)."""
    rng = np.random.default_rng(1)
    a = rng.uniform(0.5, 1.0, (3, 50, 4)).astype(np.float32)
    b = rng.normal(0, 1, (3, 50, 4)).astype(np.float32)
    _, h = trglru.associative_scan(trglru._combine, (torch.as_tensor(a),
                                                     torch.as_tensor(b)),
                                   axis=1)
    want, run = [], np.zeros((3, 4))
    for t in range(50):
        run = a[:, t] * run + b[:, t]
        want.append(run)
    close(h, np.stack(want, axis=1))


@pytest.mark.parametrize("s", [2, 64])
def test_rglru_forward_matches_jax(s):
    """Output and the decode hand-off: ``h[:, -1]`` float32 and the last
    three pre-conv inputs, left-padded when S < 3."""
    p, m = block()
    x = np.random.default_rng(s).normal(0, 1, (2, s, 48)).astype(np.float32)
    jout, jst = jax.jit(jrglru.rglru_forward)(p, jnp.asarray(x))
    tout, tst = trglru.rglru_forward(m, torch.as_tensor(x))
    close(tout, jout)
    assert tst["h"].dtype == torch.float32 and tst["conv"].shape == (2, 3, 40)
    close(tst["h"], jst["h"])
    close(tst["conv"], jst["conv"])


def test_rglru_decode_matches_jax():
    p, m = block(seed=1)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 1, 48)).astype(np.float32)
    h = rng.normal(0, 1, (2, 40)).astype(np.float32)
    tail = rng.normal(0, 1, (2, 3, 40)).astype(np.float32)
    want = jax.jit(jrglru.rglru_decode)(p, jnp.asarray(x), jnp.asarray(h),
                                        jnp.asarray(tail))
    got = trglru.rglru_decode(m, torch.as_tensor(x), torch.as_tensor(h),
                              torch.as_tensor(tail))
    for g, w in zip(got, want):
        close(g, w)


def test_rglru_bf16_keeps_log_lambda_f32():
    """A bf16 block against the reference's float32 leaves cast at use:
    ``log_lambda`` stays float32 (the reference reads it so)."""
    p, m = block(dtype=torch.bfloat16)
    assert m.log_lambda.dtype == torch.float32
    assert m.w_r.dtype == torch.bfloat16
    x = np.random.default_rng(3).normal(0, 1, (2, 24, 48))
    jout, jst = jax.jit(jrglru.rglru_forward)(p, jnp.asarray(x,
                                                           jnp.bfloat16))
    tout, tst = trglru.rglru_forward(m, torch.as_tensor(x).to(torch.bfloat16))
    close(tout, jout, rtol=0, atol=BF16_ATOL)
    close(tst["h"], jst["h"], rtol=0, atol=BF16_ATOL)


def test_rglru_init_distributions():
    """``conv_b`` zeros; ``lam = exp(-8 softplus(log_lambda))`` inside
    (0.9, 0.999) and spread over it."""
    m = trglru.rglru_init(torch.Generator().manual_seed(0), 64,
                          trglru.RGLRUDims(4096), torch.bfloat16)
    assert m.log_lambda.dtype == torch.float32
    assert torch.equal(m.conv_b, torch.zeros_like(m.conv_b))
    lam = torch.exp(-8.0 * trglru.softplus(m.log_lambda))
    assert float(lam.min()) > 0.9 - 1e-6 and float(lam.max()) < 0.999 + 1e-6
    assert abs(float(lam.mean()) - 0.9495) < 0.005


# ----------------------------------------------------------------------
# The model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_and_decode_match_jax(dtype):
    """Prefill logits and cache (the RG-LRU states and the local-attention
    k/v), then 6 decode steps' logits and the states they wrote."""
    jc, tc, params, model = models(dtype)
    rng = np.random.default_rng(4)
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
        for t, j in zip(tcache, jax_cache_layers(jcache, jc)):
            assert sorted(t) == sorted(j)
            for k in t:
                close(t[k], j[k])


@pytest.mark.parametrize("s", [64, 1024])
def test_train_forward_matches_jax(s):
    """tests/test_torch_train.py's loss check: S = 64 and 1,024, both past
    the 32-token local window."""
    check_train_forward(ARCH, s)


def test_grads_match_jax():
    """tests/test_torch_train.py's gradient check through the scan, every
    leaf."""
    check_grads(ARCH)


def test_ring_decode_matches_windowed():
    """A ring cache of the local window's capacity against the full cache
    with the window mask, past the window; the recurrent states pass
    through both alike."""
    _, tc, _, model = models()
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tc.vocab_size, (2, 45))
    with torch.no_grad():
        _, ring = ttr.prefill_forward(model, tc, {"tokens": toks},
                                      tc.local_window, ring=True)
        _, full = ttr.prefill_forward(model, tc, {"tokens": toks}, 53)
        assert ring[2]["k"].shape[1] == tc.local_window
        tok = rng.integers(0, tc.vocab_size, (2,))
        for i in range(8):
            a, ring = ttr.decode_step(model, tc, ring, tok, 45 + i,
                                      ring=True)
            b, full = ttr.decode_step(model, tc, full, tok, 45 + i)
            close(a, b)
            tok = torch.argmax(b, -1)


def test_init_cache_is_the_reference_zero_state():
    tc = get_config(ARCH, "smoke")
    cache = ttr.init_cache(tc, 3, 20, device="cpu")
    jcache = jax_cache_layers(jtr.init_cache(jax_config(ARCH, "smoke"), 3,
                                             20), tc)
    assert len(cache) == len(jcache) == 3
    for t, j in zip(cache, jcache):
        assert sorted(t) == sorted(j)
        for k in t:
            assert t[k].shape == j[k].shape
            assert str(t[k].dtype) == f"torch.{j[k].dtype}"
            np.testing.assert_array_equal(np32(t[k]), np32(j[k]))


def test_serving_model_keeps_the_reference_f32_leaf():
    """The bf16 serving model carried across from the reference's float32
    tree: ``log_lambda`` float32, the matrices bf16; its prefill against
    the JAX package's on that float32 tree (what the JAX ``ServeEngine``
    serves) at the bf16 bound."""
    jc, tc, params, model = models(torch.bfloat16)
    blk = model.layers[0].rglru
    assert blk.log_lambda.dtype == torch.float32
    assert blk.w_r.dtype == torch.bfloat16 and blk.conv_b.dtype == \
        torch.bfloat16
    served = ttr.init_params(0, tc, device="cpu")
    assert served.layers[1].rglru.log_lambda.dtype == torch.float32
    toks = np.random.default_rng(7).integers(0, 512, (2, 24))
    jl, _ = jax.jit(lambda p, t: jtr.prefill_forward(
        p, jc, {"tokens": t}, capacity=32))(params, jnp.asarray(toks))
    with torch.no_grad():
        tl, _ = ttr.prefill_forward(model, tc, {"tokens": toks}, 32)
    close(tl, jl, rtol=0, atol=BF16_ATOL)
