"""Grouped-query attention with RoPE, causal/sliding-window masking,
query-chunked computation, and KV-cache decode (full cache or ring buffer
for sliding-window long context). Port of ``repro/models/attention.py``.

Layout conventions (the JAX package's, kept at every function here):
  activations  x : (B, S, D)
  flat q/k/v     : (B, S, H, hd)   (k/v repeated kv-major: h = kv*G + g)
  kv cache       : k and v each (B, C, KV, hd)

The rounding points are the reference's: the score product runs in the
compute dtype and is rounded there, then cast to float32, scaled and
masked; the float32 softmax is cast back to the compute dtype before the
product with v. Plain einsum/softmax keep them, which a fused attention
call would not. The JAX package's sharding constraints are no-ops on one
card and are dropped.

Decode writes the new key and value into the preallocated cache in place
(the reference returns updated copies) and returns the same tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import (apply_rope, dense_init, frozen,
                                       make_rope)

NEG_INF = -1e30


class AttnDims(NamedTuple):
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: Optional[int] = None  # sliding window; None = full attention


# ----------------------------------------------------------------------
# Params
# ----------------------------------------------------------------------

class Attention(nn.Module):
    """``wq`` (D, H, hd), ``wk``/``wv`` (D, KV, hd), ``wo`` (H, hd, D)."""

    def __init__(self, wq, wk, wv, wo):
        super().__init__()
        self.wq, self.wk = frozen(wq), frozen(wk)
        self.wv, self.wo = frozen(wv), frozen(wo)


def attn_init(gen: torch.Generator, d_model: int, dims: AttnDims,
              dtype=torch.float32) -> Attention:
    h, kvh, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    return Attention(
        dense_init(gen, (d_model, h, hd), d_model).to(dtype),
        dense_init(gen, (d_model, kvh, hd), d_model).to(dtype),
        dense_init(gen, (d_model, kvh, hd), d_model).to(dtype),
        dense_init(gen, (h, hd, d_model), h * hd).to(dtype))


# ----------------------------------------------------------------------
# Core attention math (flat heads)
# ----------------------------------------------------------------------

def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """(..., Sq, Sk) additive float32 mask from absolute positions."""
    rel = q_pos[..., :, None] - k_pos[..., None, :]
    valid = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        valid &= rel >= 0
    if window is not None:
        valid &= rel < window
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32)


def flat_scores_softmax_out(q, k, v, mask):
    """q (B,Sq,H,hd), k/v (B,Sk,H,hd), mask (Bm,Sq,Sk) -> (B,Sq,H,hd);
    softmax in float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhe,bshe->bhqs", q, k)
    scores = scores.to(torch.float32) * scale + mask[:, None]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bshe->bqhe", w.to(v.dtype), v)
    return out.to(q.dtype)


def gqa_scores_softmax_out(q, k, v, mask):
    """Grouped decode form. q (B,Sq,KV,G,hd), k/v (B,Sk,KV,hd),
    mask (Bm,Sq,Sk) -> (B,Sq,KV,G,hd)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k)
    scores = scores.to(torch.float32) * scale + mask[:, None, None]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)
    return out.to(q.dtype)


def _chunk_attention(qi, k, v, pi, k_positions, causal, window):
    mask = _mask(pi, k_positions, causal, window)
    return flat_scores_softmax_out(qi, k, v, mask[None])


def chunked_causal_attention(q, k, v, q_positions, k_positions, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             chunk: int = 256,
                             remat: bool = False) -> torch.Tensor:
    """Flat-head full-sequence attention over query chunks, so the
    (cq, Sk) score tile (not (Sq, Sk)) is the peak transient. Queries are
    padded to a chunk multiple (positions repeat the last one), as in the
    reference. With ``remat`` each chunk is rematerialised (the
    reference's ``jax.checkpoint`` of its chunk body), so backward
    recomputes the (cq, Sk) scores instead of keeping them."""
    sq = q.shape[1]
    if sq <= chunk:
        mask = _mask(q_positions, k_positions, causal, window)
        return flat_scores_softmax_out(q, k, v, mask[None])
    pad = (-sq) % chunk
    if pad:
        q = torch.cat([q, q.new_zeros((q.shape[0], pad) + q.shape[2:])],
                      dim=1)
        q_positions = torch.cat([q_positions,
                                 q_positions[-1:].expand(pad)])
    outs = []
    for start in range(0, sq + pad, chunk):
        args = (q[:, start:start + chunk], k, v,
                q_positions[start:start + chunk], k_positions, causal,
                window)
        outs.append(checkpoint(_chunk_attention, *args, use_reentrant=False)
                    if remat else _chunk_attention(*args))
    return torch.cat(outs, dim=1)[:, :sq]


# ----------------------------------------------------------------------
# Block-level API
# ----------------------------------------------------------------------

def _project_q_flat(params: Attention, x):
    """x (B,S,D) -> q (B,S,H,hd)."""
    return torch.einsum("bsd,dhe->bshe", x, params.wq.to(x.dtype))


def _project_kv(params: Attention, x):
    """x (B,S,D) -> k, v (B,S,KV,hd)."""
    k = torch.einsum("bsd,dkh->bskh", x, params.wk.to(x.dtype))
    v = torch.einsum("bsd,dkh->bskh", x, params.wv.to(x.dtype))
    return k, v


def _repeat_heads(kv, g: int):
    """(B,S,KV,hd) -> (B,S,H,hd), kv-major."""
    return torch.repeat_interleave(kv, g, dim=2)


def _project_qkv(params: Attention, x, dims: AttnDims):
    """Grouped projection (decode path): q (B,S,KV,G,hd), k/v (B,S,KV,hd)."""
    b, s, _ = x.shape
    g = dims.n_heads // dims.n_kv_heads
    q = _project_q_flat(params, x).reshape(b, s, dims.n_kv_heads, g,
                                           dims.head_dim)
    k, v = _project_kv(params, x)
    return q, k, v


def _out_proj(params: Attention, out, dtype):
    return torch.einsum("bshe,hed->bsd", out, params.wo.to(dtype))


def attention_forward(params: Attention, x, positions, dims: AttnDims, *,
                      causal: bool = True, chunk: int = 256,
                      return_kv: bool = False, remat: bool = False):
    """Training / prefill path (flat heads). positions (S,) absolute,
    float32. Returns out (B,S,D), and with ``return_kv`` the rotated
    grouped (k, v) as cache material. ``remat`` rematerialises each query
    chunk (training)."""
    g = dims.n_heads // dims.n_kv_heads
    q = _project_q_flat(params, x)
    k, v = _project_kv(params, x)
    cos, sin = make_rope(positions, dims.head_dim, dims.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = chunked_causal_attention(q, _repeat_heads(k, g),
                                   _repeat_heads(v, g), positions, positions,
                                   causal=causal, window=dims.window,
                                   chunk=chunk, remat=remat)
    out = _out_proj(params, out, x.dtype)
    if return_kv:
        return out, (k, v)
    return out


def decode_mask(pos: int, c: int, ring: bool, window: Optional[int],
                device) -> torch.Tensor:
    """(1, 1, C) additive mask of the cache entries a query at ``pos``
    sees: a ring slot i holds absolute position pos - ((pos - i) mod C),
    valid when >= 0 (and inside ``window`` when it is below C); a full
    cache holds position i at slot i, valid up to ``pos`` (and inside
    ``window``, for sliding-window attention)."""
    idx = torch.arange(c, device=device)
    if ring:
        abs_pos = pos - torch.remainder(pos - idx, c)
        valid = abs_pos >= 0
        if window is not None and window < c:
            valid &= (pos - abs_pos) < window
    else:
        valid = idx <= pos
        if window is not None:
            valid &= idx > pos - window
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32)[None, None, :]


def attention_decode(params: Attention, x, pos: int, cache_k, cache_v,
                     dims: AttnDims, *, ring: bool = False,
                     window: Optional[int] = None):
    """One-token decode. x (B,1,D); pos the absolute position (an int);
    cache_k/v (B, C, KV, hd) hold rotated keys for positions < pos.

    ``ring=True`` treats the cache as a ring buffer of size C (the new kv
    goes to slot ``pos % C``); otherwise C is the full context and the new
    kv goes to slot ``min(pos, C - 1)``. The slot is written in place.

    Returns (out (B,1,D), cache_k, cache_v).
    """
    pos = int(pos)
    b = x.shape[0]
    c = cache_k.shape[1]
    q, k, v = _project_qkv(params, x, dims)
    cos, sin = make_rope(torch.full((1,), pos, dtype=torch.float32,
                                    device=x.device), dims.head_dim,
                         dims.rope_theta)
    q = apply_rope(q.reshape(b, 1, -1, dims.head_dim), cos, sin) \
        .reshape(q.shape)
    k = apply_rope(k, cos, sin)
    slot = pos % c if ring else min(pos, c - 1)
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    mask = decode_mask(pos, c, ring, window, x.device)
    out = gqa_scores_softmax_out(q, cache_k.to(q.dtype), cache_v.to(q.dtype),
                                 mask)
    out = out.reshape(b, 1, dims.n_heads, dims.head_dim)
    return _out_proj(params, out, x.dtype), cache_k, cache_v
