"""Shared model building blocks: norms, RoPE, initializers, activations
(port of ``repro/models/common.py``).

The math is plain functions on tensors; the layers that hold parameters are
``nn.Module``s in the sibling modules. Initializers draw from an explicit
``torch.Generator`` in float32; a model casts its matrices to the compute
dtype once, when it is built or loaded.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, scaled by ``1 + scale``, back in ``x``'s dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dtype)


def make_rope(positions: torch.Tensor, head_dim: int,
              theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin tables (..., head_dim//2), float32."""
    freqs = torch.exp(
        -math.log(theta) * torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim)
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd); cos/sin (..., S, hd//2) broadcast over heads. The
    rotation of the concatenated halves runs in float32 and is rounded to
    ``x``'s dtype once."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": _gelu_tanh,
        "relu": F.relu,
        "tanh": torch.tanh,
    }[name]


# ----------------------------------------------------------------------
# Parameter init helpers (float32 draws from an explicit generator)
# ----------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, in_axis_size: int
               ) -> torch.Tensor:
    scale = 1.0 / math.sqrt(in_axis_size)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * scale


def embed_init(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * 0.02


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter that takes no gradient, as a serving model's do; a
    training master turns gradients on for all of them at once
    (``model.requires_grad_()``)."""
    return nn.Parameter(t, requires_grad=False)


def count_params(model: nn.Module) -> int:
    return sum(int(p.numel()) for p in model.parameters())
