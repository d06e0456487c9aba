"""Carry weights and data across to the port.

The JAX package's models and splits arrive here as numpy arrays
(``np.asarray(jax_gmm.weights)`` etc.), so nothing here imports JAX:
:func:`gmm_from_numpy` builds a port :class:`GMM` on a device,
:func:`gmm_to_numpy` turns one back into arrays, and
:func:`split_to_clients` puts a padded numpy ``ClientSplit`` on a device
as :class:`SplitClients`. For the transformer substrate,
:func:`model_params_from_jax` builds the port's model from the JAX
package's parameter tree (:func:`model_params_to_jax` is its inverse, so
the port's trainer writes checkpoints in the JAX package's layout) and
:func:`monitor_from_jax` carries a JAX monitor's projection and global
GMM across.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from repro_torch.core.config import resolve_device
from repro_torch.core.gmm import GMM
from repro_torch.fed.runtime import SplitClients
from repro_torch.models.attention import Attention
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import MoE
from repro_torch.models.rglru import RGLRU
from repro_torch.models.transformer import (Block, Encoder, ModelConfig,
                                            RGLRUBlock, Transformer,
                                            XLSTMBlock, check_supported)
from repro_torch.models.xlstm import MLSTM, SLSTM
from repro_torch.monitor.activation_monitor import (FedGMMMonitor,
                                                    MonitorConfig)


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def gmm_from_numpy(weights, means, covs, device="cuda") -> GMM:
    """A float32 port model on ``device`` from (weights, means, covs)
    arrays, single (K, ...) or stacked (C, K, ...)."""
    return GMM(_tensor(weights, device), _tensor(means, device),
               _tensor(covs, device))


def gmm_to_numpy(gmm: GMM) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(weights, means, covs) of a port model as numpy arrays."""
    return tuple(t.detach().cpu().numpy()
                 for t in (gmm.weights, gmm.means, gmm.covs))


def split_to_clients(split, device="cuda") -> SplitClients:
    """A padded split (``data (C, N, d)``, ``mask (C, N)``, ``sizes (C,)``
    numpy arrays, as ``partition`` makes them in either package) as
    :class:`SplitClients` on ``device``, which keeps ``split``."""
    return SplitClients(_tensor(split.data, device),
                        _tensor(split.mask, device), np.asarray(split.sizes),
                        split)


def _cast(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device, dtype)


def _mlp_from_jax(f: dict, mat) -> MLP:
    return MLP(mat(f["w_up"]), mat(f["w_down"]),
               mat(f["w_gate"]) if "w_gate" in f else None)


def _attention_from_jax(a: dict, mat) -> Attention:
    return Attention(mat(a["wq"]), mat(a["wk"]), mat(a["wv"]), mat(a["wo"]))


def _block_from_jax(p: dict, dtype, device) -> nn.Module:
    """One layer of the JAX tree, by its keys: an attention layer (with
    ``lnx``/``xattn`` cross-attention, a dense ``ffn`` or an MoE ``moe``
    block), an ``rglru`` layer or an ``mlstm``/``slstm`` one. Matrices in
    ``dtype``; the norm scales and the recurrent leaves the reference
    reads in float32 (``log_lambda``, ``b_if``, ``b``, ``r``) in
    float32."""
    mat = functools.partial(_cast, dtype=dtype, device=device)
    f32 = functools.partial(_cast, dtype=torch.float32, device=device)
    if "rglru" in p:
        g = p["rglru"]
        cell = RGLRU(*(mat(g[k]) for k in ("w_gate_in", "w_rec_in", "conv_w",
                                           "conv_b", "w_r", "w_i")),
                     f32(g["log_lambda"]), mat(g["w_out"]))
        return RGLRUBlock(f32(p["ln1"]), cell, f32(p["ln2"]),
                          _mlp_from_jax(p["ffn"], mat))
    if "mlstm" in p:
        m = p["mlstm"]
        return XLSTMBlock(f32(p["ln"]), mlstm=MLSTM(
            *(mat(m[k]) for k in ("w_up", "wq", "wk", "wv", "w_if")),
            f32(m["b_if"]), mat(m["w_down"])))
    if "slstm" in p:
        m = p["slstm"]
        return XLSTMBlock(f32(p["ln"]), slstm=SLSTM(
            mat(m["w_in"]), f32(m["r"]), f32(m["b"]), mat(m["w_up"]),
            mat(m["w_down"])))
    cross = {}
    if "xattn" in p:
        cross = dict(lnx=f32(p["lnx"]),
                     xattn=_attention_from_jax(p["xattn"], mat))
    attention = _attention_from_jax(p["attn"], mat)
    ln1, ln2 = f32(p["ln1"]), f32(p["ln2"])
    if "ffn" in p:
        return Block(ln1, attention, ln2, ffn=_mlp_from_jax(p["ffn"], mat),
                     **cross)
    m = p["moe"]
    shared = _mlp_from_jax(m["shared"], mat) if "shared" in m else None
    return Block(ln1, attention, ln2, moe=MoE(
        mat(m["router"]), mat(m["w_gate"]), mat(m["w_up"]),
        mat(m["w_down"]), shared), **cross)


def model_params_from_jax(params_np: dict, cfg: ModelConfig, device="cuda",
                          *, dtype=None) -> Transformer:
    """The port's model from the JAX package's parameter tree with numpy
    leaves (``jax.tree.map(np.asarray, params)``): ``head_layers``, the
    stacked ``blocks`` unstacked over their leading group axis (group g,
    pattern position p is layer ``first_k_dense + g * len(pattern) + p``),
    then ``tail``; an encoder-decoder's ``encoder`` (its stacked
    ``blocks``, one a layer, and ``final_norm``). Matrices are cast once
    to ``dtype`` (default ``cfg.dtype``, as the reference's serving steps
    cast them); norm scales and the four float32 recurrent leaves stay
    float32. ``dtype=torch.float32`` gives the float32 masters a trainer
    updates (``.requires_grad_()`` turns their gradients on)."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = cfg.dtype if dtype is None else dtype
    layers = [_block_from_jax(p, dtype, device)
              for p in params_np["head_layers"]]
    for g in range(cfg.n_groups):
        for stacked in params_np["blocks"]:
            layers.append(_block_from_jax(
                _index_tree(stacked, g), dtype, device))
    layers += [_block_from_jax(p, dtype, device) for p in params_np["tail"]]
    encoder = None
    if cfg.n_enc_layers:
        enc = params_np["encoder"]
        encoder = Encoder(
            [_block_from_jax(_index_tree(enc["blocks"], i), dtype, device)
             for i in range(cfg.n_enc_layers)],
            _cast(enc["final_norm"], torch.float32, device))
    return Transformer(cfg, _cast(params_np["embed"], dtype, device),
                       _cast(params_np["head"], dtype, device),
                       _cast(params_np["final_norm"], torch.float32, device),
                       layers, encoder)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A float32 numpy copy (never a view of the tensor's memory)."""
    return np.array(t.detach().to("cpu", torch.float32).numpy())


def _module_tree(m: nn.Module) -> dict:
    """A module's parameters as the JAX package's nested dict of numpy
    leaves (its submodule and parameter names are the JAX keys)."""
    tree = {n: _numpy(p) for n, p in m.named_parameters(recurse=False)}
    for name, child in m.named_children():
        tree[name] = _module_tree(child)
    return tree


def model_params_to_jax(model: Transformer) -> dict:
    """The inverse of :func:`model_params_from_jax`: the JAX package's
    parameter tree with numpy leaves (``embed``, ``head``, ``final_norm``,
    ``head_layers``, ``blocks`` stacked over their group axis, one entry a
    pattern position and ``None`` when there is no full group, ``tail``
    and, for an encoder-decoder, ``encoder``), so
    ``repro.checkpoint.load_checkpoint`` restores what
    ``repro_torch.checkpoint.save_checkpoint`` writes of it. Leaves are
    float32 numpy arrays (bf16 is widened exactly)."""
    cfg = model.cfg
    layers = [_module_tree(b) for b in model.layers]
    head, n = cfg.first_k_dense, len(cfg.pattern)
    body = layers[head:head + cfg.n_groups * n]
    blocks = [_stack([body[g * n + i] for g in range(cfg.n_groups)])
              if cfg.n_groups else None for i in range(n)]
    tree = {"embed": _numpy(model.embed), "head": _numpy(model.head),
            "final_norm": _numpy(model.final_norm),
            "head_layers": layers[:head], "blocks": blocks,
            "tail": layers[head + cfg.n_groups * n:]}
    if model.encoder is not None:
        tree["encoder"] = {
            "blocks": _stack([_module_tree(b) for b in model.encoder.layers]),
            "final_norm": _numpy(model.encoder.final_norm)}
    return tree


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def monitor_from_jax(cfg: ModelConfig, mcfg: MonitorConfig, proj,
                     global_gmm=None, device="cuda") -> FedGMMMonitor:
    """A port monitor with a JAX monitor's projection matrix ``proj``
    (d_model, feature_dim) and, if given, its global GMM as (weights,
    means, covs) arrays."""
    mon = FedGMMMonitor(cfg, mcfg, device=device)
    mon.proj = _cast(proj, torch.float32, mon.device)
    if global_gmm is not None:
        mon.global_gmm = gmm_from_numpy(*global_gmm, device=mon.device)
    return mon
