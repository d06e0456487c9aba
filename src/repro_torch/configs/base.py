"""Architecture registry + the assigned input shapes + the dry-run's input
specs (port of ``repro/configs/base.py``).

Every registered architecture has a full-size ``ModelConfig`` (the paper's
dimensions) and a ``smoke`` reduced variant used by the CPU tests. The port
registers all ten of the JAX package's: the five dense-attention decoders,
the two MoE ones (deepseek-moe-16b, mixtral-8x7b), the hybrid recurrent
recurrentgemma-9b, xlstm-350m and the encoder-decoder seamless-m4t-medium.
``input_specs`` gives the dry-run's inputs as meta tensors (shapes and
dtypes, nothing allocated), the counterpart of the reference's
``ShapeDtypeStruct`` trees.

Input shapes (assigned):
    train_4k      seq_len=4096    global_batch=256   (train_step)
    prefill_32k   seq_len=32768   global_batch=32    (prefill_step)
    decode_32k    seq_len=32768   global_batch=128   (serve_step, full cache)
    long_500k     seq_len=524288  global_batch=1     (serve_step, ring cache)
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import ModelConfig, init_cache

INPUT_SHAPES = {
    "train_4k": {"seq_len": 4096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768, "global_batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32768, "global_batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524288, "global_batch": 1, "kind": "decode_ring"},
}

_REGISTRY: dict[str, dict] = {}


def register(arch_id: str, full: ModelConfig, smoke: ModelConfig,
             citation: str):
    _REGISTRY[arch_id] = {"full": full, "smoke": smoke, "citation": citation}


def get_config(arch_id: str, variant: str = "full") -> ModelConfig:
    _ensure_loaded()
    return _REGISTRY[arch_id][variant]


def get_citation(arch_id: str) -> str:
    _ensure_loaded()
    return _REGISTRY[arch_id]["citation"]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if not _REGISTRY:
        from repro_torch.configs import (  # noqa: F401
            deepseek_67b, deepseek_moe_16b, gemma_7b, internlm2_1_8b,
            internvl2_26b, mixtral_8x7b, recurrentgemma_9b,
            seamless_m4t_medium, xlstm_350m, yi_6b)


# ----------------------------------------------------------------------
# Dry-run input specs (meta tensors: shapes and dtypes, no allocation)
# ----------------------------------------------------------------------

def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype``: the counterpart of
    ``jax.ShapeDtypeStruct``."""
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """The inputs of one (arch, input-shape) cell as meta tensors: a
    ``batch`` dict for train and prefill; ``cache`` (:func:`init_cache`'s
    list, built on meta), ``token`` and ``pos`` for the decode kinds.

    Modality frontends are stubs, as in the reference: vision/audio
    entries are precomputed embeddings of the right shape."""
    sh = INPUT_SHAPES[shape_name]
    b, s = sh["global_batch"], sh["seq_len"]
    kind = sh["kind"]
    if kind in ("train", "prefill"):
        batch = {"tokens": sds((b, s), torch.int32)}
        if kind == "train":
            batch["targets"] = sds((b, s), torch.int32)
            batch["mask"] = sds((b, s), torch.float32)
        if cfg.frontend == "vision":
            batch["prefix"] = sds((b, cfg.n_prefix, cfg.d_model), cfg.dtype)
        if cfg.n_enc_layers:
            batch["src_embeds"] = sds((b, s // cfg.src_ratio, cfg.d_model),
                                      cfg.dtype)
        return {"batch": batch}
    # decode kinds: ONE new token + a cache of the context length
    enc_len = s // cfg.src_ratio if cfg.n_enc_layers else 0
    return {
        "cache": init_cache(cfg, b, decode_capacity(cfg, shape_name),
                            device="meta", enc_len=enc_len),
        "token": sds((b,), torch.int32),
        "pos": sds((), torch.int32),
    }


def decode_capacity(cfg: ModelConfig, shape_name: str) -> int:
    sh = INPUT_SHAPES[shape_name]
    return cfg.long_window if sh["kind"] == "decode_ring" else sh["seq_len"]


def uses_ring(shape_name: str) -> bool:
    return INPUT_SHAPES[shape_name]["kind"] == "decode_ring"
