"""Dense feed-forward blocks: gated (SwiGLU/GeGLU) and plain (port of
``repro/models/mlp.py``)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import activation_fn, dense_init, frozen


class MLP(nn.Module):
    """``w_up`` (d_model, d_ff), ``w_down`` (d_ff, d_model) and, gated,
    ``w_gate`` (d_model, d_ff), in the compute dtype."""

    def __init__(self, w_up: torch.Tensor, w_down: torch.Tensor,
                 w_gate: torch.Tensor = None):
        super().__init__()
        self.w_up = frozen(w_up)
        self.w_down = frozen(w_down)
        self.w_gate = None if w_gate is None else frozen(w_gate)

    def forward(self, x: torch.Tensor, activation: str = "silu"
                ) -> torch.Tensor:
        return mlp_forward(self, x, activation)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             gated: bool = True, dtype=torch.float32) -> MLP:
    w_up = dense_init(gen, (d_model, d_ff), d_model).to(dtype)
    w_down = dense_init(gen, (d_ff, d_model), d_ff).to(dtype)
    w_gate = (dense_init(gen, (d_model, d_ff), d_model).to(dtype)
              if gated else None)
    return MLP(w_up, w_down, w_gate)


def mlp_forward(params: MLP, x: torch.Tensor,
                activation: str = "silu") -> torch.Tensor:
    act = activation_fn(activation)
    up = x @ params.w_up.to(x.dtype)
    if params.w_gate is not None:
        up = act(x @ params.w_gate.to(x.dtype)) * up
    else:
        up = act(up)
    return up @ params.w_down.to(x.dtype)
