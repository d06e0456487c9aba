"""RG-LRU recurrent block, the RecurrentGemma / Griffin temporal block (port
of ``repro/models/rglru.py``).

Structure (Griffin recurrent block):
    x -> [linear -> gelu] gate branch
      -> [linear -> causal depthwise conv1d(w=4) -> RG-LRU] recurrent branch
    out = W_out (gate * recurrent)

RG-LRU:  r_t = sigmoid(W_r x),  i_t = sigmoid(W_i x)
         a_t = exp(-c * softplus(lambda) * r_t)          (c = 8)
         h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full-sequence form runs the recurrence as a log-depth parallel prefix
over the affine maps ``h -> a h + b`` (:func:`associative_scan`, the
odd-even recursion ``jax.lax.associative_scan`` uses, with the reference's
``combine``, so the rounding follows the reference's order). Decode keeps
an O(1) state: ``h`` (B, d_rnn) float32 and the last three pre-conv inputs
(B, 3, d_rnn).

``log_lambda`` stays float32 in a serving model (the reference reads it as
float32); the other leaves follow the model's compute dtype. On a mesh
d_rnn rides the model axis (the reference's constraint on the recurrent
branch's input), and the causal conv runs on each rank's channels.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import dense_init, frozen
from repro_torch.models.sharding_ctx import (constrain, einsum, local,
                                             matmul)

_C = 8.0
CONV_W = 4


class RGLRUDims(NamedTuple):
    d_rnn: int


class RGLRU(nn.Module):
    """``w_gate_in``/``w_rec_in`` (D, dr), ``conv_w`` (4, dr), ``conv_b``
    (dr,), ``w_r``/``w_i`` (dr, dr), ``log_lambda`` (dr,) and ``w_out``
    (dr, D): the JAX package's leaves."""

    def __init__(self, w_gate_in, w_rec_in, conv_w, conv_b, w_r, w_i,
                 log_lambda, w_out):
        super().__init__()
        self.w_gate_in, self.w_rec_in = frozen(w_gate_in), frozen(w_rec_in)
        self.conv_w, self.conv_b = frozen(conv_w), frozen(conv_b)
        self.w_r, self.w_i = frozen(w_r), frozen(w_i)
        self.log_lambda = frozen(log_lambda)
        self.w_out = frozen(w_out)


def rglru_init(gen: torch.Generator, d_model: int, dims: RGLRUDims,
               dtype=torch.float32) -> RGLRU:
    """Weights drawn in float32, matrices cast to ``dtype``; ``conv_b``
    zeros; ``lam ~ U(0.9, 0.999)`` parametrised as ``log_lambda =
    log(exp(-log(lam) / 8) - 1)``, kept float32."""
    dr = dims.d_rnn
    w_gate_in = dense_init(gen, (d_model, dr), d_model)
    w_rec_in = dense_init(gen, (d_model, dr), d_model)
    conv_w = dense_init(gen, (CONV_W, dr), CONV_W)
    w_r = dense_init(gen, (dr, dr), dr)
    w_i = dense_init(gen, (dr, dr), dr)
    w_out = dense_init(gen, (dr, d_model), dr)
    lam = torch.rand((dr,), generator=gen, dtype=torch.float32,
                     device=gen.device) * (0.999 - 0.9) + 0.9
    log_lambda = torch.log(torch.exp(-torch.log(lam) / _C) - 1.0)
    return RGLRU(w_gate_in.to(dtype), w_rec_in.to(dtype), conv_w.to(dtype),
                 torch.zeros((dr,), dtype=dtype, device=gen.device),
                 w_r.to(dtype), w_i.to(dtype), log_lambda, w_out.to(dtype))


def rglru_specs(fsdp_axis="data") -> dict:
    return {
        "w_gate_in": (fsdp_axis, "model"),
        "w_rec_in": (fsdp_axis, "model"),
        "conv_w": (None, "model"),
        "conv_b": ("model",),
        "w_r": (fsdp_axis, "model"),
        "w_i": (fsdp_axis, "model"),
        "log_lambda": ("model",),
        "w_out": ("model", fsdp_axis),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``), with no linear cut-off."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x, w, b):
    """Depthwise causal conv width 4 as shifted adds. x (B,S,dr)."""
    out = x * w[CONV_W - 1]
    for j in range(1, CONV_W):
        shifted = F.pad(x, (0, 0, j, 0))[:, :-j]
        out = out + shifted * w[CONV_W - 1 - j]
    return out + b


def _gates(params: RGLRU, u):
    """u (..., dr) in the compute dtype -> (a, b) float32: the decay and the
    input term of ``h_t = a_t h_{t-1} + b_t``."""
    r = torch.sigmoid(matmul(u, params.w_r.to(u.dtype), n="model"))
    i = torch.sigmoid(matmul(u, params.w_i.to(u.dtype), n="model"))
    decay = softplus(params.log_lambda.to(torch.float32))
    a = torch.exp(-_C * decay * r.to(torch.float32))
    bterm = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * \
        (i.to(torch.float32) * u.to(torch.float32))
    return a, bterm


def _combine(e1, e2):
    """The affine composition: apply (a1, b1), then (a2, b2)."""
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor, axis: int):
    """Elements of ``even`` at even and of ``odd`` at odd indices along
    ``axis``; ``even`` is as long as ``odd`` or one longer."""
    n_odd = odd.shape[axis]
    head = even.narrow(axis, 0, n_odd)
    out = torch.stack([head, odd], dim=axis + 1).flatten(axis, axis + 1)
    if even.shape[axis] > n_odd:
        out = torch.cat([out, even.narrow(axis, n_odd, 1)], dim=axis)
    return out


def associative_scan(fn: Callable, elems: tuple, axis: int = 0) -> tuple:
    """Inclusive scan of a tuple of tensors under the associative ``fn``
    along ``axis``, by the odd-even recursion of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan the halved
    sequence, then fill in the even positions. Log depth in plain torch
    ops; autograd runs through it."""
    axis = axis % elems[0].dim()

    def every_other(e, start, stop=None):
        idx = [slice(None)] * e.dim()
        idx[axis] = slice(start, stop, 2)
        return e[tuple(idx)]

    def scan(elems):
        n = elems[0].shape[axis]
        if n < 2:
            return elems
        reduced = fn(tuple(every_other(e, 0, -1) for e in elems),
                     tuple(every_other(e, 1) for e in elems))
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn(tuple(o.narrow(axis, 0, o.shape[axis] - 1)
                            for o in odd),
                      tuple(every_other(e, 2) for e in elems))
        else:
            even = fn(odd, tuple(every_other(e, 2) for e in elems))
        even = tuple(torch.cat([e.narrow(axis, 0, 1), r], dim=axis)
                     for e, r in zip(elems, even))
        return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))

    return scan(tuple(elems))


def rglru_forward(params: RGLRU, x):
    """Training / prefill. x (B, S, D) -> (out (B,S,D), state {"h": (B,dr)
    float32, "conv": (B,3,dr) the last three pre-conv inputs, left-padded
    with zeros when S < 3, in ``x``'s dtype})."""
    u_pre = constrain(matmul(x, params.w_rec_in.to(x.dtype), n="model"),
                      ("batch", None, "model"))                 # (B,S,dr)
    u = local(_causal_conv, (u_pre, params.conv_w.to(u_pre.dtype),
                             params.conv_b.to(u_pre.dtype)),
              (("batch", None, "model"), (None, "model"), ("model",)))
    a, bterm = _gates(params, u)
    _, h = associative_scan(_combine, (a, bterm), axis=1)
    gate = F.gelu(matmul(x, params.w_gate_in.to(x.dtype), n="model"),
                  approximate="tanh")
    out = matmul(gate * h.to(x.dtype), params.w_out.to(x.dtype), k="model")
    s = x.shape[1]
    if s >= CONV_W - 1:
        tail = u_pre[:, s - (CONV_W - 1):]
    else:
        tail = F.pad(u_pre, (0, 0, CONV_W - 1 - s, 0))
    return out, {"h": h[:, -1].to(torch.float32), "conv": tail}


def rglru_decode(params: RGLRU, x, h_prev, conv_tail):
    """One-token decode. x (B,1,D); h_prev (B,dr) float32; conv_tail
    (B,3,dr) the last three pre-conv inputs. Returns (out (B,1,D), h,
    new_conv_tail)."""
    u_new = matmul(x, params.w_rec_in.to(x.dtype),
                   n="model")[:, 0]                             # (B, dr)
    w = params.conv_w.to(u_new.dtype)
    hist = torch.cat([conv_tail.to(u_new.dtype), u_new[:, None]], dim=1)
    u = einsum("bwd,wd->bd", hist, w, shard={"b": "batch", "d": "model"}) \
        + params.conv_b.to(u_new.dtype)
    a, bterm = _gates(params, u)
    h = a * h_prev + bterm                                      # (B, dr) f32
    gate = F.gelu(matmul(x, params.w_gate_in.to(x.dtype), n="model")[:, 0],
                  approximate="tanh")
    out = matmul(gate * h.to(x.dtype), params.w_out.to(x.dtype), k="model")
    return out[:, None], h, hist[:, 1:].to(conv_tail.dtype)

