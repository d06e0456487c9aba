"""AdamW with global-norm clipping and a cosine LR schedule (port of
``repro/optim/adamw.py``).

The parameters are a mapping of name -> float32 master tensor (``dict(
model.named_parameters())``); the optimizer state holds ``m`` and ``v`` as
mappings of the same names in float32 and ``step`` as a host int. One
update runs as ``torch._foreach_*`` ops under ``no_grad``, in place on the
masters and the moments, with the reference's arithmetic: the global norm
over every leaf in float32, the clip scale ``min(1, clip / max(norm,
1e-9))``, bias corrections ``1 - beta ** step`` in float32, and ``p - lr *
(mh / (sqrt(vh) + eps) + wd * p)`` on every leaf, norm scales and
embeddings included. ``torch.optim.AdamW`` is another function: it decays
before the moment update and keeps neither the clip nor the schedule.

The schedule and the bias corrections are float32 host scalars (the step
is a host int), so an update reads nothing back from the device; the
clip scale stays on the device.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.models.sharding_ctx import is_dtensor


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def _named(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params) -> dict:
    """Zero float32 moments named as ``params`` (a module or a mapping of
    name -> tensor), and step 0."""
    params = _named(params)
    zeros = {n: torch.zeros_like(p, dtype=torch.float32,
                                 memory_format=torch.contiguous_format)
             for n, p in params.items()}
    return {"m": zeros,
            "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": 0}


def opt_state_specs(params_specs: dict) -> dict:
    """The moments take their parameters' specs; the step (a host int
    here, the reference's int32 scalar) is replicated."""
    return {"m": params_specs, "v": params_specs, "step": ()}


def schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup, then cosine down to a 0.1 floor, in float32 as the
    reference computes it; returned as a Python float (a float32 value)."""
    f32 = np.float32
    step = f32(step)
    warm = np.minimum(step / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    frac = np.clip((step - f32(cfg.warmup_steps))
                   / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * frac))
    return float(f32(cfg.lr) * warm * (f32(0.1) + f32(0.9) * cos))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over every leaf of its float32 sum of squares; a
    0-d float32 tensor. ``tree`` is a mapping or a sequence of tensors."""
    leaves = list(tree.values()) if isinstance(tree, Mapping) else list(tree)
    norms = torch._foreach_norm([g.to(torch.float32) for g in leaves])
    return torch.sqrt(torch.sum(torch.square(torch.stack(norms))))


@torch.no_grad()
def apply_updates(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step, in place on ``params`` (name -> float32 master) and
    on ``state``'s moments; ``grads`` (name -> tensor) is consumed as
    scratch. Returns (params, state, metrics): ``grad_norm`` a 0-d device
    tensor, ``lr`` a float."""
    params = _named(params)
    names = list(params)
    ps = [params[n] for n in names]
    gs = [grads[n].to(torch.float32) for n in names]
    ms = [state["m"][n] for n in names]
    vs = [state["v"][n] for n in names]
    step = int(state["step"]) + 1
    gnorm = global_norm(gs)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    f32 = np.float32
    b1c = float(f32(1.0) - f32(cfg.beta1) ** f32(step))
    b2c = float(f32(1.0) - f32(cfg.beta2) ** f32(step))

    torch._foreach_mul_(gs, scale)
    torch._foreach_mul_(ms, cfg.beta1)
    torch._foreach_add_(ms, gs, alpha=1 - cfg.beta1)
    torch._foreach_mul_(vs, cfg.beta2)
    torch._foreach_addcmul_(vs, gs, gs, value=1 - cfg.beta2)
    # the gradients are spent: their buffers take sqrt(vh) + eps (DTensor
    # has no strategy for _foreach_copy_: its buffers are zeroed and added
    # to, 0 + v being v bit for bit)
    if is_dtensor(gs[0]):
        torch._foreach_zero_(gs)
        torch._foreach_add_(gs, vs)
    else:
        torch._foreach_copy_(gs, vs)
    torch._foreach_div_(gs, b2c)
    torch._foreach_sqrt_(gs)
    torch._foreach_add_(gs, cfg.eps)
    upd = torch._foreach_div(ms, b1c)
    torch._foreach_div_(upd, gs)
    del gs
    torch._foreach_add_(upd, [p.to(torch.float32) for p in ps],
                        alpha=cfg.weight_decay)
    # computed in float32, rounded to each parameter's dtype in place
    torch._foreach_add_(ps, upd, alpha=-lr)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
