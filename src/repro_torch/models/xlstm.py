"""xLSTM blocks: mLSTM (matrix memory, parallel/chunked training form) and
sLSTM (scalar memory, sequential over time), Beck et al. '24
(arXiv:2405.04517). Port of ``repro/models/xlstm.py``.

- mLSTM trains in its parallel quadratic form, over query chunks of
  ``chunk`` rows when the sequence is longer (the (cq, S) decay tile, not
  (S, S), is the peak transient); with gradients on, each chunk is
  rematerialised (the reference checkpoints every chunk whatever
  ``cfg.remat`` says). Decode is O(1) with the (C, n, m) matrix-memory
  state. The parallel form's stabiliser (``max(max log D, 0)``) and the
  recurrent one (``max(log f + m, i)``) are the reference's own, so
  prefill -> decode agrees only as closely as the reference's does.
- sLSTM is a true recurrence through a nonlinearity: a Python loop over
  time of :func:`_slstm_cell`. There is no parallel form.

In a serving model ``mlstm.b_if``, ``slstm.b`` and ``slstm.r`` stay
float32, as in the reference's float32 parameter tree; the recurrence
casts ``h`` to ``r``'s dtype, so it runs in float32 there and in the
compute dtype under a train step (which casts every leaf).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import dense_init, frozen


class XLSTMDims(NamedTuple):
    n_heads: int
    head_dim: int     # d_model // n_heads after up-projection
    up_factor: int = 2


# ======================================================================
# mLSTM
# ======================================================================

class MLSTM(nn.Module):
    """``w_up`` (D, 2 d_inner), ``wq``/``wk``/``wv`` (d_inner, H, hd),
    ``w_if`` (d_inner, 2H), ``b_if`` (2H,) and ``w_down`` (d_inner, D)."""

    def __init__(self, w_up, wq, wk, wv, w_if, b_if, w_down):
        super().__init__()
        self.w_up = frozen(w_up)
        self.wq, self.wk, self.wv = frozen(wq), frozen(wk), frozen(wv)
        self.w_if, self.b_if = frozen(w_if), frozen(b_if)
        self.w_down = frozen(w_down)


def mlstm_init(gen: torch.Generator, d_model: int, dims: XLSTMDims,
               dtype=torch.float32) -> MLSTM:
    """Matrices drawn in float32 and cast to ``dtype``; ``b_if`` zeros for
    the input gates and 3.0 for the forget gates, kept float32."""
    d_inner = dims.n_heads * dims.head_dim
    qkv = (d_inner, dims.n_heads, dims.head_dim)
    w_up = dense_init(gen, (d_model, 2 * d_inner), d_model)
    wq = dense_init(gen, qkv, d_inner)
    wk = dense_init(gen, qkv, d_inner)
    wv = dense_init(gen, qkv, d_inner)
    w_if = dense_init(gen, (d_inner, 2 * dims.n_heads), d_inner)
    w_down = dense_init(gen, (d_inner, d_model), d_inner)
    b_if = torch.cat([
        torch.zeros((dims.n_heads,), dtype=torch.float32, device=gen.device),
        torch.full((dims.n_heads,), 3.0, dtype=torch.float32,
                   device=gen.device)])
    return MLSTM(*(w.to(dtype) for w in (w_up, wq, wk, wv, w_if)), b_if,
                 w_down.to(dtype))


def _mlstm_gates(params: MLSTM, u):
    """u (B,S,d_inner) -> (log_f (B,S,H), i_tilde (B,S,H)) in float32."""
    gf = (u @ params.w_if.to(u.dtype)).to(torch.float32) + \
        params.b_if.to(torch.float32)
    h = gf.shape[-1] // 2
    i_tilde, f_tilde = gf[..., :h], gf[..., h:]
    # log sigmoid(f~) = -softplus(-f~), as min(f~, 0) - log1p(exp(-|f~|))
    log_f = F.logsigmoid(f_tilde)
    return log_f, i_tilde


def _mlstm_block(qc, lc, k, lcum, i_tilde, v, start: int, dtype):
    """One query chunk of the parallel form. qc (B,cq,H,hd); lc (B,cq,H)
    the chunk rows' cumulative log f; k/v (B,S,H,hd); lcum/i_tilde
    (B,S,H) -> (B,cq,H,hd) in ``dtype``."""
    s = k.shape[1]
    scale = 1.0 / math.sqrt(k.shape[-1])
    # log D[t, s] = lcum_t - lcum_s + i~_s   for s <= t
    logd = lc[:, :, None, :] - lcum[:, None, :, :] + i_tilde[:, None, :, :]
    cq = qc.shape[1]
    t_idx = start + torch.arange(cq, device=qc.device)
    causal = t_idx[:, None] >= torch.arange(s, device=qc.device)[None, :]
    logd = torch.where(causal[None, :, :, None], logd, -math.inf)
    m = torch.clamp(torch.amax(logd, dim=2), min=0.0)     # (B,cq,H)
    dmat = torch.exp(logd - m[:, :, None, :])             # (B,cq,S,H)
    scores = torch.einsum("bqhe,bshe->bqsh", qc.to(torch.float32),
                          k.to(torch.float32)) * scale
    cmat = scores * dmat
    norm = torch.maximum(torch.abs(torch.sum(cmat, dim=2)), torch.exp(-m))
    out = torch.einsum("bqsh,bshe->bqhe", cmat / norm[:, :, None, :],
                       v.to(torch.float32))
    return out.to(dtype)


def mlstm_forward(params: MLSTM, x, chunk: int = 256):
    """Parallel (training/prefill) form. x (B,S,D) -> (out, last_state):
    one block when S <= ``chunk``, else queries padded to a multiple of
    ``chunk`` (their cumulative log f padded with its last value) and run
    chunk by chunk."""
    b, s, _ = x.shape
    n_heads = params.w_if.shape[1] // 2
    up = x @ params.w_up.to(x.dtype)
    u, gate = torch.chunk(up, 2, dim=-1)                  # (B,S,d_inner)
    d_inner = u.shape[-1]
    hd = d_inner // n_heads
    q = torch.einsum("bsd,dhe->bshe", u, params.wq.to(u.dtype))
    k = torch.einsum("bsd,dhe->bshe", u, params.wk.to(u.dtype))
    v = torch.einsum("bsd,dhe->bshe", u, params.wv.to(u.dtype))
    log_f, i_tilde = _mlstm_gates(params, u)              # (B,S,H)
    lcum = torch.cumsum(log_f, dim=1)                     # (B,S,H) prefix

    if s <= chunk:
        h = _mlstm_block(q, lcum, k, lcum, i_tilde, v, 0, x.dtype)
    else:
        pad = (-s) % chunk
        qp = F.pad(q, (0, 0, 0, 0, 0, pad)) if pad else q
        lp = torch.cat([lcum, lcum[:, -1:].expand(b, pad, n_heads)],
                       dim=1) if pad else lcum
        remat = torch.is_grad_enabled()
        hs = []
        for start in range(0, s + pad, chunk):
            args = (qp[:, start:start + chunk], lp[:, start:start + chunk],
                    k, lcum, i_tilde, v, start, x.dtype)
            hs.append(checkpoint(_mlstm_block, *args, use_reentrant=False)
                      if remat else _mlstm_block(*args))
        h = torch.cat(hs, dim=1)[:, :s]

    h = h.reshape(b, s, d_inner) * F.silu(gate)
    out = h @ params.w_down.to(x.dtype)
    # recurrent state equivalent at t = S (for prefill -> decode handoff)
    return out, _mlstm_state_from_seq(k, v, log_f, i_tilde)


def _mlstm_state_from_seq(k, v, log_f, i_tilde):
    """Fold the whole sequence into the (C, n, m) decode state."""
    lcum = torch.cumsum(log_f, dim=1)
    total = lcum[:, -1:]
    # weight of step t in final state: exp(lcum_S - lcum_t + i~_t - m)
    logw = total - lcum + i_tilde                         # (B,S,H)
    m = torch.amax(logw, dim=1)                           # (B,H)
    w = torch.exp(logw - m[:, None])
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    c = torch.einsum("bsh,bshe,bshf->bhef", w, kf, vf)
    n = torch.einsum("bsh,bshe->bhe", w, kf)
    return {"c": c, "n": n, "m": m}


def mlstm_decode(params: MLSTM, x, state):
    """One-token decode. state {c (B,H,hd,hd), n (B,H,hd), m (B,H)}, all
    float32 -> (out (B,1,D), new state)."""
    b = x.shape[0]
    n_heads = params.w_if.shape[1] // 2
    up = x @ params.w_up.to(x.dtype)
    u, gate = torch.chunk(up, 2, dim=-1)
    u2, gate = u[:, 0], gate[:, 0]
    d_inner = u2.shape[-1]
    hd = d_inner // n_heads
    q = torch.einsum("bd,dhe->bhe", u2, params.wq.to(u2.dtype))
    k = torch.einsum("bd,dhe->bhe", u2, params.wk.to(u2.dtype))
    v = torch.einsum("bd,dhe->bhe", u2, params.wv.to(u2.dtype))
    log_f, i_tilde = _mlstm_gates(params, u2[:, None])
    log_f, i_tilde = log_f[:, 0], i_tilde[:, 0]           # (B,H)
    m_new = torch.maximum(log_f + state["m"], i_tilde)
    fp = torch.exp(log_f + state["m"] - m_new)
    ip = torch.exp(i_tilde - m_new)
    kf, vf, qf = (t.to(torch.float32) for t in (k, v, q))
    c = state["c"] * fp[..., None, None] + \
        ip[..., None, None] * kf[..., :, None] * vf[..., None, :]
    n = state["n"] * fp[..., None] + ip[..., None] * kf
    scale = 1.0 / math.sqrt(hd)
    num = torch.einsum("bhef,bhe->bhf", c, qf * scale)
    den = torch.maximum(torch.abs(torch.einsum("bhe,bhe->bh", n, qf * scale)),
                        torch.exp(-m_new))
    h = (num / den[..., None]).reshape(b, d_inner).to(x.dtype)
    h = h * F.silu(gate)
    out = (h @ params.w_down.to(x.dtype))[:, None]
    return out, {"c": c, "n": n, "m": m_new}


# ======================================================================
# sLSTM
# ======================================================================

def _up_width(d_model: int) -> int:
    return max(256, (4 * d_model // 3 + 255) // 256 * 256)


class SLSTM(nn.Module):
    """``w_in`` (D, 4D), ``r`` (H, hd, 4 hd) the block-diagonal recurrence,
    ``b`` (4D,), ``w_up`` (D, 2 up) and ``w_down`` (up, D), up =
    :func:`_up_width`."""

    def __init__(self, w_in, r, b, w_up, w_down):
        super().__init__()
        self.w_in, self.r, self.b = frozen(w_in), frozen(r), frozen(b)
        self.w_up, self.w_down = frozen(w_up), frozen(w_down)


def slstm_init(gen: torch.Generator, d_model: int, dims: XLSTMDims,
               dtype=torch.float32) -> SLSTM:
    """Matrices drawn in float32 and cast to ``dtype``; ``r`` and the zero
    ``b`` kept float32."""
    h, hd = dims.n_heads, d_model // dims.n_heads
    up = _up_width(d_model)
    w_in = dense_init(gen, (d_model, 4 * d_model), d_model)
    r = dense_init(gen, (h, hd, 4 * hd), hd)
    w_up = dense_init(gen, (d_model, 2 * up), d_model)
    w_down = dense_init(gen, (up, d_model), up)
    b = torch.zeros((4 * d_model,), dtype=torch.float32, device=gen.device)
    return SLSTM(w_in.to(dtype), r, b, w_up.to(dtype), w_down.to(dtype))


def _slstm_cell(params: SLSTM, wx_t, state, n_heads: int, bias):
    """One timestep. wx_t (B, 4D) float32, the precomputed input part;
    state a dict of (B, D) float32 tensors; ``bias`` is ``params.b`` as
    float32, cast once by the caller."""
    r = params.r
    h_prev = state["h"]
    b, d = h_prev.shape
    hd = d // n_heads
    rh = torch.einsum("bhe,hef->bhf",
                      h_prev.reshape(b, n_heads, hd).to(r.dtype),
                      r).reshape(b, 4 * d)
    pre = wx_t + rh.to(torch.float32) + bias
    z, i_t, f_t, o = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    log_f = F.logsigmoid(f_t)
    decayed = log_f + state["m"]
    m_new = torch.maximum(decayed, i_t)
    fp = torch.exp(decayed - m_new)
    ip = torch.exp(i_t - m_new)
    c = fp * state["c"] + ip * z
    n = fp * state["n"] + ip
    h = o * c / torch.clamp(n, min=1e-6)
    return {"h": h, "c": c, "n": n, "m": m_new}


def slstm_zero_state(batch: int, d_model: int, device) -> dict:
    """The full-sequence form's start: zeros and ``m = -1e30``."""
    z = torch.zeros((batch, d_model), dtype=torch.float32, device=device)
    return {"h": z, "c": z, "n": z,
            "m": torch.full((batch, d_model), -1e30, dtype=torch.float32,
                            device=device)}


def _slstm_out(params: SLSTM, h, dtype):
    up = h.to(dtype) @ params.w_up.to(dtype)
    a, g = torch.chunk(up, 2, dim=-1)
    return (F.gelu(g, approximate="tanh") * a) @ params.w_down.to(dtype)


def slstm_forward(params: SLSTM, x, n_heads: int):
    """Sequential over time. x (B,S,D) -> (out, last_state)."""
    b, s, d = x.shape
    wx = (x @ params.w_in.to(x.dtype)).to(torch.float32)   # (B,S,4D)
    state = slstm_zero_state(b, d, x.device)
    bias = params.b.to(torch.float32)
    hs = []
    for t in range(s):
        state = _slstm_cell(params, wx[:, t], state, n_heads, bias)
        hs.append(state["h"])
    h = torch.stack(hs, dim=1)                             # (B,S,D) f32
    return _slstm_out(params, h, x.dtype), state


def slstm_decode(params: SLSTM, x, state, n_heads: int):
    wx = (x[:, 0] @ params.w_in.to(x.dtype)).to(torch.float32)
    new = _slstm_cell(params, wx, state, n_heads,
                      params.b.to(torch.float32))
    return _slstm_out(params, new["h"], x.dtype)[:, None], new
