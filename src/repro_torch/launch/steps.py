"""Step functions (train / prefill / decode) of the substrate (port of
``repro/launch/steps.py``), shared by the trainer and the serving loop.

The JAX package's sharding specs and jit assembly (``build_jitted``,
``to_shardings``, ``batch_specs``) wait for the mesh and dry-run item of
ROADMAP Queue A.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.transformer import (ModelConfig, Transformer,
                                            decode_step, prefill_forward,
                                            train_forward)
from repro_torch.optim.adamw import AdamWConfig, apply_updates

METRICS = ("loss", "nll", "aux", "grad_norm")


class _LossAndGrads(nn.Module):
    """``train_forward`` and its backward in one call, so that both run
    while ``torch.func.functional_call`` has the compute casts in place: a
    rematerialised segment recomputes from the casts, not the masters."""

    def __init__(self, model: Transformer, cfg: ModelConfig):
        super().__init__()
        self.model = model
        self.cfg = cfg

    def forward(self, batch: dict, masters: list):
        loss, metrics = train_forward(self.model, self.cfg, batch)
        grads = torch.autograd.grad(loss, masters)
        return loss, metrics, grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """``train_step(model, opt_state, batch) -> metrics``: one AdamW step
    of the float32 masters ``model`` (every parameter trainable, as
    ``init_params(..., master=True)`` builds them) and ``opt_state``, both
    updated in place. Every floating leaf of the masters, norm scales and
    embeddings included, is cast to ``cfg.dtype`` once a step, and
    ``train_forward`` runs on the casts through
    ``torch.func.functional_call``, so autograd routes the gradients back
    to the masters. Metrics: ``loss``, ``nll``, ``aux``, ``grad_norm`` and
    ``lr`` as Python floats, read from the device once a step."""

    def train_step(model: Transformer, opt_state: dict, batch: dict):
        named = dict(model.named_parameters())
        frozen = [n for n, p in named.items() if not p.requires_grad]
        if frozen:
            raise ValueError(
                f"train_step needs trainable float32 masters "
                f"(init_params(..., master=True)); {frozen[0]!r} takes no "
                f"gradient")
        casts = {f"model.{n}": p.to(cfg.dtype) if p.is_floating_point()
                 else p for n, p in named.items()}
        loss, metrics, grads = torch.func.functional_call(
            _LossAndGrads(model, cfg), casts, (batch, list(named.values())))
        del casts
        _, _, opt_metrics = apply_updates(named, dict(zip(named, grads)),
                                          opt_state, opt_cfg)
        values = torch.stack([loss.detach(), metrics["nll"].detach(),
                              metrics["aux"].detach(),
                              opt_metrics["grad_norm"]]).tolist()
        return dict(zip(METRICS, values), lr=opt_metrics["lr"])

    return train_step


def make_prefill_step(cfg: ModelConfig, capacity: int, ring: bool = False):
    def prefill_step(params, batch):
        return prefill_forward(params, cfg, batch, capacity, ring)

    return prefill_step


def make_decode_step(cfg: ModelConfig, ring: bool = False):
    def serve_step(params, cache, token, pos):
        return decode_step(params, cfg, cache, token, pos, ring=ring)

    return serve_step
