"""The port's capacity-routed MoE block (``repro_torch.models.moe``) against
``repro.models.moe`` on the same numpy weights and inputs.

Tolerances: float32 output and aux loss rtol/atol 1e-5; float32 gradients
(``torch.autograd`` against ``jax.grad``) 1e-4 relative to each tensor's
largest entry (``max |got - want| <= 1e-4 * max |want|``: entries near
zero carry the rounding of their large neighbours' sums); bfloat16 output
atol 5e-2, the substrate's bf16 bound (tests/test_torch_models.py), and
its float32 aux loss rtol/atol 1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 5e-2
# the two smoke configs' MoE dims (configs/deepseek_moe_16b.py,
# configs/mixtral_8x7b.py), at d_model 256
SMOKE = {"deepseek-moe-16b": dict(n_experts=4, top_k=2, d_ff=128,
                                  n_shared=1, group_size=64),
         "mixtral-8x7b": dict(n_experts=4, top_k=2, d_ff=512,
                              group_size=64)}
D = 256


def np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, dtype=np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(np32(got), np32(want), **(tol or F32))


def close_rel(got, want, rel=1e-4):
    """max |got - want| <= rel * max |want| (a tensor-wise relative
    bound)."""
    got, want = np32(got), np32(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, np.abs(want).max())


def both(seed=0, d=D, **dims):
    """JAX params, the same weights as a port module, and both dims."""
    jd, td = jmoe.MoEDims(**dims), tmoe.MoEDims(**dims)
    p = jmoe.moe_init(jax.random.key(seed), d, jd)
    shared = None
    if "shared" in p:
        s = p["shared"]
        shared = tmoe.MLP(*(torch.tensor(np.array(s[k]))
                            for k in ("w_up", "w_down", "w_gate")))
    mod = tmoe.MoE(*(torch.tensor(np.array(p[k]))
                     for k in ("router", "w_gate", "w_up", "w_down")),
                   shared)
    return p, mod, jd, td


def run(p, mod, jd, td, x, dtype=torch.float32, act="silu"):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jo, ja = jmoe.moe_forward(p, jnp.asarray(x, jdt), jd, act)
    to, ta = tmoe.moe_forward(mod, torch.tensor(x).to(dtype), td, act)
    return (to, ta), (jo, ja)


def inputs(b, s, seed=1, d=D):
    return np.random.default_rng(seed).normal(0, 1, (b, s, d)) \
        .astype(np.float32)


@pytest.mark.parametrize("arch", sorted(SMOKE))
def test_forward_matches_jax(arch):
    p, mod, jd, td = both(**SMOKE[arch])
    (to, ta), (jo, ja) = run(p, mod, jd, td, inputs(2, 64))
    assert to.shape == (2, 64, D) and ta.ndim == 0
    assert ta.dtype == torch.float32
    close(to, jo)
    close(ta, ja)


@pytest.mark.parametrize("b,s", [(3, 25), (1, 7), (5, 64)])
def test_tokens_not_a_group_multiple(b, s):
    """75, 7 and 320 tokens at group size 64: zero-padded to a group
    multiple (one group of 7 below the group size), the pads sliced off."""
    p, mod, jd, td = both(**SMOKE["deepseek-moe-16b"])
    (to, ta), (jo, ja) = run(p, mod, jd, td, inputs(b, s, seed=2))
    close(to, jo)
    close(ta, ja)


def test_top_k_stable_orders_ties_as_jax():
    """Equal values come out lower index first, as ``jax.lax.top_k``."""
    rng = np.random.default_rng(3)
    v = rng.integers(0, 3, (64, 8)).astype(np.float32)   # many ties
    jv, ji = jax.lax.top_k(jnp.asarray(v), 4)
    tv, ti = tmoe.top_k_stable(torch.tensor(v), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_forced_router_ties(cf):
    """Router columns 1 and 3 equal column 0, so every token's logits tie
    three ways; which experts a token takes, and so the capacity priority,
    follows the lower index first in both packages."""
    dims = dict(SMOKE["mixtral-8x7b"], capacity_factor=cf)
    p, mod, jd, td = both(**dims)
    router = np.array(p["router"])
    router[:, 1] = router[:, 0]
    router[:, 3] = router[:, 0]
    p = dict(p, router=jnp.asarray(router))
    mod.router.data = torch.tensor(router)
    (to, ta), (jo, ja) = run(p, mod, jd, td, inputs(2, 64, seed=4))
    close(to, jo)
    close(ta, ja)


def dispatched(mod, td, x):
    """Token-expert choices that kept a slot (the dispatch tensor's sum)."""
    t = x.shape[0] * x.shape[1]
    tokens = torch.tensor(x).reshape(-1, 64, x.shape[-1])
    logits = tokens @ mod.router
    _, idx = tmoe.top_k_stable(logits, td.top_k)
    counts = torch.nn.functional.one_hot(idx, td.n_experts).sum((1, 2))
    cap = tmoe.capacity(td, 64)
    return int(torch.clamp(counts, max=cap).sum()), t * td.top_k


def test_capacity_factor_that_drops():
    """At capacity factor 0.5 an expert takes 16 of a group's 128 choices:
    choices are dropped, and the kept ones are the reference's."""
    dims = dict(SMOKE["deepseek-moe-16b"], capacity_factor=0.5)
    p, mod, jd, td = both(**dims)
    x = inputs(2, 64, seed=5)
    kept, total = dispatched(mod, td, x)
    assert kept < total
    (to, ta), (jo, ja) = run(p, mod, jd, td, x)
    close(to, jo)
    close(ta, ja)


@pytest.mark.parametrize("n_shared", [1, 2])
def test_shared_experts(n_shared):
    """Always-on shared experts (an MLP of width n_shared * d_ff) added on
    the unpadded input."""
    dims = dict(SMOKE["deepseek-moe-16b"], n_shared=n_shared)
    p, mod, jd, td = both(**dims)
    assert mod.shared.w_up.shape == (D, n_shared * 128)
    (to, ta), (jo, ja) = run(p, mod, jd, td, inputs(3, 25, seed=6))
    close(to, jo)
    close(ta, ja)


@pytest.mark.parametrize("arch", sorted(SMOKE))
def test_bf16(arch):
    """The configs' own dtype: router product, expert einsums and combine
    in bf16; the aux loss float32."""
    p, mod, jd, td = both(**SMOKE[arch])
    mod = mod.to(torch.bfloat16)
    (to, ta), (jo, ja) = run(p, mod, jd, td, inputs(2, 64, seed=7),
                             dtype=torch.bfloat16)
    assert to.dtype == torch.bfloat16 and ta.dtype == torch.float32
    close(to, jo, rtol=0, atol=BF16_ATOL)
    close(ta, ja, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("arch", sorted(SMOKE))
def test_grads_match_jax(arch):
    """Gradients of sum(out * w) + aux with respect to the input and every
    weight (router, expert stacks, shared experts)."""
    p, mod, jd, td = both(**SMOKE[arch])
    x = inputs(2, 40, seed=8)
    w = np.random.default_rng(9).normal(0, 1, x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_forward(p, x, jd)
        return jnp.sum(out * w) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    mod.requires_grad_()
    xt = torch.tensor(x, requires_grad=True)
    out, aux = tmoe.moe_forward(mod, xt, td)
    (torch.sum(out * torch.tensor(w)) + aux).backward()
    close_rel(xt.grad, jgx)
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert float(getattr(mod, name).grad.abs().max()) > 0
        close_rel(getattr(mod, name).grad, jgp[name])
    if "shared" in jgp:
        for name in ("w_up", "w_down", "w_gate"):
            close_rel(getattr(mod.shared, name).grad, jgp["shared"][name])


def test_capacity():
    """cap = min(ceil(gs * k * cf / E), gs): deepseek-moe-16b's decode
    group of 4 tokens gets one slot an expert; a drop-free factor (E)
    gives the whole group."""
    ds = tmoe.MoEDims(n_experts=64, top_k=6, d_ff=1408, n_shared=2,
                      group_size=512)
    assert tmoe.capacity(ds, 512) == 60
    assert tmoe.capacity(ds, 4) == 1
    assert tmoe.capacity(ds._replace(capacity_factor=64.0), 4) == 4
