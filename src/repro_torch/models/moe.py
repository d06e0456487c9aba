"""Mixture-of-Experts FFN: GShard/Switch-style capacity-based token routing
with top-k gating, the load-balance aux loss and optional always-on shared
experts (DeepSeekMoE). Port of ``repro/models/moe.py``.

Tokens are routed within fixed-size groups, so the dispatch tensor stays
(G, Tg, E, C) with C = min(ceil(Tg * top_k * capacity_factor / E), Tg).
Routing priority is the reference's: every token's rank-0 choice, then
every rank-1 choice, and so on, each expert filling its C slots in that
order; a choice past capacity is dropped. Capacity couples the tokens of
a group, so a token's output depends on its group's other tokens unless
``capacity_factor`` is ``n_experts`` (no drop is possible).

Top-k is a stable descending sort, so equal router logits go to the lower
expert index first, as ``jax.lax.top_k`` orders them (``torch.topk`` on
CUDA promises no order among ties, and the order decides capacity
priority). The rounding points are the reference's: the router product in
the compute dtype, cast to float32 for the softmax; dispatch and combine
cast to the compute dtype for the expert einsums (dispatch is exact: at
most one nonzero a slot; combine weights round); the aux loss in float32.
The JAX package's sharding constraints are no-ops on one card and are
dropped; the expert products are plain einsums there and here.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.models.common import activation_fn, dense_init, frozen
from repro_torch.models.mlp import MLP, mlp_forward, mlp_init


class MoEDims(NamedTuple):
    n_experts: int
    top_k: int
    d_ff: int                  # per-expert hidden width
    n_shared: int = 0          # DeepSeekMoE shared experts (always on)
    capacity_factor: float = 1.25
    group_size: int = 1024
    expert_sharding: str = "auto"  # "expert" | "tensor" | "auto"


class MoE(nn.Module):
    """``router`` (D, E), ``w_gate``/``w_up`` (E, D, F), ``w_down`` (E, F,
    D) and, with shared experts, ``shared`` (a gated :class:`MLP` of width
    ``n_shared * F``)."""

    def __init__(self, router, w_gate, w_up, w_down, shared: MLP = None):
        super().__init__()
        self.router = frozen(router)
        self.w_gate = frozen(w_gate)
        self.w_up = frozen(w_up)
        self.w_down = frozen(w_down)
        self.shared = shared


def moe_init(gen: torch.Generator, d_model: int, dims: MoEDims,
             dtype=torch.float32) -> MoE:
    e, f = dims.n_experts, dims.d_ff
    router = dense_init(gen, (d_model, e), d_model).to(dtype)
    w_gate = dense_init(gen, (e, d_model, f), d_model).to(dtype)
    w_up = dense_init(gen, (e, d_model, f), d_model).to(dtype)
    w_down = dense_init(gen, (e, f, d_model), f).to(dtype)
    shared = (mlp_init(gen, d_model, dims.n_shared * f, gated=True,
                       dtype=dtype) if dims.n_shared else None)
    return MoE(router, w_gate, w_up, w_down, shared)


def capacity(dims: MoEDims, gs: int) -> int:
    """Expert slots a group of ``gs`` tokens gives each expert."""
    cap = int(math.ceil(gs * dims.top_k * dims.capacity_factor
                        / dims.n_experts))
    return min(cap, gs)


def top_k_stable(logits: torch.Tensor, k: int):
    """The k largest values along the last axis and their indices, equal
    values in ascending index order (``jax.lax.top_k``'s order)."""
    idx = torch.sort(logits, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(logits, -1, idx), idx


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of ``idx`` over n classes; an index outside [0, n)
    gives a zero row (as ``jax.nn.one_hot``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def moe_forward(params: MoE, x: torch.Tensor, dims: MoEDims,
                activation: str = "silu"):
    """x (B, S, D) -> (out (B, S, D), aux loss, a 0-d float32 tensor)."""
    b, s, d = x.shape
    t = b * s
    tokens = x.reshape(t, d)
    gs = min(dims.group_size, t)
    pad = (-t) % gs
    if pad:  # zero-pad to a group multiple; padded rows are sliced off below
        tokens = torch.cat([tokens, tokens.new_zeros((pad, d))])
    g = (t + pad) // gs
    tokens = tokens.reshape(g, gs, d)
    e, k = dims.n_experts, dims.top_k
    cap = capacity(dims, gs)

    logits = (tokens @ params.router.to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                       # (g, gs, E)
    top_w, top_i = top_k_stable(logits, k)                      # (g, gs, K)
    top_w = torch.softmax(top_w, dim=-1)                        # renormalize

    onehot = _one_hot(top_i, e)                                 # (g,gs,K,E)
    # priority order: all rank-0 choices first, then rank-1, ...
    prio = onehot.permute(0, 2, 1, 3).reshape(g, k * gs, e)
    pos = torch.cumsum(prio, dim=1) - 1.0                       # slot index
    keep = (pos < cap).to(torch.float32) * prio
    slot = _one_hot(pos.to(torch.int64), cap) * keep[..., None]
    slot = slot.reshape(g, k, gs, e, cap).permute(0, 2, 1, 3, 4)

    dispatch = torch.sum(slot, dim=2)                           # (g,gs,E,C)
    combine = torch.sum(slot * top_w[..., None, None], dim=2)   # (g,gs,E,C)

    xin = torch.einsum("gtec,gtd->gecd", dispatch.to(x.dtype), tokens)
    act = activation_fn(activation)
    h = act(torch.einsum("gecd,edf->gecf", xin,
                         params.w_gate.to(x.dtype))) \
        * torch.einsum("gecd,edf->gecf", xin, params.w_up.to(x.dtype))
    xout = torch.einsum("gecf,efd->gecd", h, params.w_down.to(x.dtype))
    out = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), xout)

    # load-balance aux loss (Switch eq. 4, averaged over groups)
    frac_dispatched = torch.mean(torch.sum(dispatch, dim=-1), dim=1)
    mean_prob = torch.mean(probs, dim=1)
    aux = e * torch.mean(torch.sum(frac_dispatched * mean_prob, dim=-1))

    out = out.reshape(g * gs, d)[:t].reshape(b, s, d)
    if params.shared is not None:
        out = out + mlp_forward(params.shared, x, activation)
    return out, aux
