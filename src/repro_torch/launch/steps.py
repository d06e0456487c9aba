"""Step functions (train / prefill / decode) of the substrate with their
sharding specs (port of ``repro/launch/steps.py``), shared by the trainer,
the serving loop and the dry-run.

A spec is a tuple of mesh-axis entries (``models/sharding_ctx.py``);
:func:`to_shardings` turns a tree of them into ``DTensor`` placements and
:func:`distribute` lays tensors out by them. The step functions take
plain tensors or ``DTensor``s; with ``DTensor`` parameters the tensors
the model makes itself (positions, masks, zeros) join them as replicated
(``implicit_replication``). ``torch.distributed.tensor`` is imported only
on those paths: a plain step never pays for its import.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import INPUT_SHAPES, input_specs, uses_ring
from repro_torch.launch.mesh import batch_axes, fsdp_axes
from repro_torch.models import sharding_ctx
from repro_torch.models.transformer import (ModelConfig, Transformer,
                                            cache_specs, decode_step,
                                            init_params, param_specs,
                                            prefill_forward, train_forward)
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                     init_opt_state)

METRICS = ("loss", "nll", "aux", "grad_norm")


def _serve_dtype(model: Transformer, cfg: ModelConfig) -> Transformer:
    """Serve every floating leaf in the compute dtype (the reference's
    serving layout: halves weight traffic), in place."""
    for name, p in list(model.named_parameters()):
        if p.is_floating_point() and p.dtype != cfg.dtype:
            mod, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(mod), leaf, nn.Parameter(
                p.detach().to(cfg.dtype), requires_grad=p.requires_grad))
    return model


def to_shardings(mesh, specs):
    """A tree of specs (nested dicts and lists, or one spec) -> the same
    tree of ``DTensor`` placement lists on ``mesh``."""
    if isinstance(specs, dict):
        return {k: to_shardings(mesh, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [to_shardings(mesh, v) for v in specs]
    return sharding_ctx.placements(mesh, specs)


def _mesh_scope(model: nn.Module):
    """``implicit_replication()`` where ``model`` holds ``DTensor``s, else
    nothing."""
    if not sharding_ctx.is_dtensor(model.embed):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def distribute(t: torch.Tensor, mesh, placements):
    """``t`` laid out on ``mesh``: a meta tensor becomes a ``DTensor`` over
    this rank's meta shard (no values, no memory); a real one is split
    from this rank's copy (``distribute_tensor``)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    if t.device.type != "meta":
        return distribute_tensor(t, mesh, placements)
    shape = compute_local_shape_and_global_offset(t.shape, mesh,
                                                  placements)[0]
    local = torch.empty(shape, dtype=t.dtype, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_params(model: nn.Module, mesh, specs: dict) -> nn.Module:
    """Swap every parameter of ``model`` for a ``DTensor`` laid out by its
    spec (``param_specs``' names), in place."""
    shardings = to_shardings(mesh, specs)
    for name, p in list(model.named_parameters()):
        mod, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(mod), leaf, nn.Parameter(
            distribute(p.detach(), mesh, shardings[name]),
            requires_grad=p.requires_grad))
    return model


def distribute_tree(tree, mesh, specs):
    """The tensors of a tree (dicts and lists: a batch, a cache, optimizer
    moments) laid out by the matching tree of specs."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, mesh, specs[k]) for k, v in
                tree.items()}
    if isinstance(tree, list):
        return [distribute_tree(v, mesh, s) for v, s in zip(tree, specs)]
    if isinstance(tree, torch.Tensor):
        return distribute(tree, mesh, sharding_ctx.placements(mesh, specs))
    return tree


def batch_specs(cfg: ModelConfig, shape_name: str, multi_pod: bool,
                kind: str) -> dict:
    sh = INPUT_SHAPES[shape_name]
    bax = batch_axes(multi_pod, sh["global_batch"])
    specs = {"tokens": (bax, None)}
    if kind == "train":
        specs["targets"] = (bax, None)
        specs["mask"] = (bax, None)
    if cfg.frontend == "vision":
        specs["prefix"] = (bax, None, None)
    if cfg.n_enc_layers:
        specs["src_embeds"] = (bax, None, None)
    return specs


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


def _whole(t):
    """A ``DTensor`` metric replicated (a partial sum or mean reduced);
    a plain tensor as it is."""
    if sharding_ctx.is_dtensor(t):
        from torch.distributed.tensor import Replicate
        return t.redistribute(t.device_mesh,
                              [Replicate()] * t.device_mesh.ndim)
    return t


def _train_step_tensors(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """The train step up to its metrics as device tensors: ``(metrics
    (4,) float32 in :data:`METRICS` order, lr)``."""

    def step(model: Transformer, opt_state: dict, batch: dict):
        named = dict(model.named_parameters())
        frozen = [n for n, p in named.items() if not p.requires_grad]
        if frozen:
            raise ValueError(
                f"train_step needs trainable float32 masters "
                f"(init_params(..., master=True)); {frozen[0]!r} takes no "
                f"gradient")
        casts = {f"model.{n}": p.to(cfg.dtype) if p.is_floating_point()
                 else p for n, p in named.items()}
        with _mesh_scope(model):
            loss, metrics, grads = torch.func.functional_call(
                _LossAndGrads(model, cfg), casts,
                (batch, list(named.values())))
            del casts
            # a DTensor gradient takes its master's layout (the FSDP
            # reduce-scatter) before the update
            grads = [g.redistribute(p.device_mesh, p.placements)
                     if sharding_ctx.is_dtensor(g) else g
                     for g, p in zip(grads, named.values())]
            _, _, opt_metrics = apply_updates(
                named, dict(zip(named, grads)), opt_state, opt_cfg)
            values = torch.stack([_whole(t.detach()) for t in (
                loss, metrics["nll"], metrics["aux"],
                opt_metrics["grad_norm"])])
        return values, opt_metrics["lr"]

    return step


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
    step = _train_step_tensors(cfg, opt_cfg)

    def train_step(model: Transformer, opt_state: dict, batch: dict):
        values, lr = step(model, opt_state, batch)
        if sharding_ctx.is_dtensor(values):
            values = values.full_tensor()
        return dict(zip(METRICS, values.tolist()), lr=lr)

    return train_step


def make_prefill_step(cfg: ModelConfig, capacity: int, ring: bool = False):
    def prefill_step(params, batch):
        with _mesh_scope(params):
            return prefill_forward(params, cfg, batch, capacity, ring)

    return prefill_step


def make_decode_step(cfg: ModelConfig, ring: bool = False):
    def serve_step(params, cache, token, pos):
        with _mesh_scope(params):
            return decode_step(params, cfg, cache, token, pos, ring=ring)

    return serve_step


# ----------------------------------------------------------------------
# Assembly for one (arch, shape, mesh) combination
# ----------------------------------------------------------------------

def build_jitted(cfg: ModelConfig, shape_name: str, mesh, *,
                 multi_pod: bool, opt_cfg: Optional[AdamWConfig] = None,
                 decode_cache_mode: str = "seq"):
    """Returns (step function, example arguments) for one cell, the
    arguments meta ``DTensor``s on ``mesh`` laid out by the specs (nothing
    is allocated and nothing is compiled: torch has no whole-program
    compiler to hand the step to; the name is the reference's).

    The reference's layouts: the FSDP float32 masters, their AdamW moments
    (``init_opt_state`` of the masters: ``opt_state_specs``' layout) and
    the batch for ``train``; for ``prefill`` and the decode kinds the
    serving layout, every floating leaf in ``cfg.dtype``, replicated over
    the data axes and sharded over model. A batch too small to shard puts
    the decode cache's length on the data axis (``seq_axis``); experts
    ride the model axis when 16 divides their count. Sets the
    ``sharding_ctx`` axes for the step. ``train`` returns ``(metrics
    (4,), lr)`` as tensors (``make_train_step`` reads them back); a decode
    step runs at the cell's last position, ``seq_len - 1``."""
    sh = INPUT_SHAPES[shape_name]
    kind = sh["kind"]
    fsdp = fsdp_axes(multi_pod)
    bax = batch_axes(multi_pod, sh["global_batch"])
    expert_ax = None
    if cfg.moe is not None and cfg.moe.n_experts % 16 == 0:
        expert_ax = "model"
    sharding_ctx.set_axes(batch=bax, model="model", expert=expert_ax)

    if kind == "train":
        opt_cfg = opt_cfg or AdamWConfig()
        p_specs = param_specs(cfg, fsdp=fsdp, model_axis_size=16)
        model = distribute_params(init_params(0, cfg, "meta", master=True),
                                  mesh, p_specs)
        opt_state = init_opt_state(model)
        batch = distribute_tree(input_specs(cfg, shape_name)["batch"], mesh,
                                batch_specs(cfg, shape_name, multi_pod,
                                            "train"))
        return _train_step_tensors(cfg, opt_cfg), (model, opt_state, batch)

    # serving layout: weights are stationary in inference, so FSDP would
    # only add per-layer all-gathers
    p_specs = param_specs(cfg, fsdp=None, model_axis_size=16)
    model = distribute_params(
        _serve_dtype(init_params(0, cfg, "meta"), cfg), mesh, p_specs)
    if kind == "prefill":
        step = make_prefill_step(cfg, sh["seq_len"])
        batch = distribute_tree(input_specs(cfg, shape_name)["batch"], mesh,
                                batch_specs(cfg, shape_name, multi_pod,
                                            "prefill"))
        return step, (model, batch)

    seq_axis = "data" if bax is None else None
    inputs = input_specs(cfg, shape_name)
    cache = distribute_tree(inputs["cache"], mesh,
                            cache_specs(cfg, bax, seq_axis,
                                        decode_cache_mode))
    token = distribute_tree(inputs["token"], mesh, (bax,))
    step = make_decode_step(cfg, uses_ring(shape_name))
    return step, (model, cache, token, sh["seq_len"] - 1)
