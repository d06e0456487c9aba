"""Carry weights and data across to the port.

The JAX package's models and splits arrive here as numpy arrays
(``np.asarray(jax_gmm.weights)`` etc.), so nothing here imports JAX:
:func:`gmm_from_numpy` builds a port :class:`GMM` on a device,
:func:`gmm_to_numpy` turns one back into arrays, and
:func:`split_to_clients` puts a padded numpy ``ClientSplit`` on a device
as :class:`SplitClients`. For the transformer substrate,
:func:`model_params_from_jax` builds the port's model from the JAX
package's parameter tree and :func:`monitor_from_jax` carries a JAX
monitor's projection and global GMM across.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.config import resolve_device
from repro_torch.core.gmm import GMM
from repro_torch.fed.runtime import SplitClients
from repro_torch.models.attention import Attention
from repro_torch.models.mlp import MLP
from repro_torch.models.transformer import (Block, ModelConfig, Transformer,
                                            check_supported)
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


def _block_from_jax(p: dict, cfg: ModelConfig, device) -> Block:
    """One decoder layer of the JAX tree: matrices in ``cfg.dtype``, the
    norm scales in float32."""
    if "ffn" not in p or "attn" not in p:
        raise NotImplementedError(
            f"layer with keys {sorted(p)} is not ported yet (ROADMAP Queue A)")
    a, f = p["attn"], p["ffn"]
    mat = functools.partial(_cast, dtype=cfg.dtype, device=device)
    return Block(_cast(p["ln1"], torch.float32, device),
                 Attention(mat(a["wq"]), mat(a["wk"]), mat(a["wv"]),
                           mat(a["wo"])),
                 _cast(p["ln2"], torch.float32, device),
                 MLP(mat(f["w_up"]), mat(f["w_down"]),
                     mat(f["w_gate"]) if "w_gate" in f else None))


def model_params_from_jax(params_np: dict, cfg: ModelConfig,
                          device="cuda") -> Transformer:
    """The port's model from the JAX package's parameter tree with numpy
    leaves (``jax.tree.map(np.asarray, params)``): ``head_layers``, the
    stacked ``blocks`` unstacked over their leading group axis (group g,
    pattern position p is layer ``first_k_dense + g * len(pattern) + p``),
    then ``tail``. Matrices are cast once to ``cfg.dtype``, as the
    reference's serving steps cast them."""
    check_supported(cfg)
    device = resolve_device(device)
    layers = [_block_from_jax(p, cfg, device)
              for p in params_np["head_layers"]]
    for g in range(cfg.n_groups):
        for stacked in params_np["blocks"]:
            layers.append(_block_from_jax(
                _index_tree(stacked, g), cfg, device))
    layers += [_block_from_jax(p, cfg, device) for p in params_np["tail"]]
    return Transformer(cfg, _cast(params_np["embed"], cfg.dtype, device),
                       _cast(params_np["head"], cfg.dtype, device),
                       _cast(params_np["final_norm"], torch.float32, device),
                       layers)


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
