"""Architecture registry + the assigned input shapes (port of
``repro/configs/base.py``).

Every registered architecture has a full-size ``ModelConfig`` (the paper's
dimensions) and a ``smoke`` reduced variant used by the CPU tests. The port
registers all ten of the JAX package's: the five dense-attention decoders,
the two MoE ones (deepseek-moe-16b, mixtral-8x7b), the hybrid recurrent
recurrentgemma-9b, xlstm-350m and the encoder-decoder seamless-m4t-medium.
The dry-run's ``input_specs``/``decode_capacity``/``uses_ring`` register
with the dry-run (ROADMAP Queue A).

Input shapes (assigned):
    train_4k      seq_len=4096    global_batch=256   (train_step)
    prefill_32k   seq_len=32768   global_batch=32    (prefill_step)
    decode_32k    seq_len=32768   global_batch=128   (serve_step, full cache)
    long_500k     seq_len=524288  global_batch=1     (serve_step, ring cache)
"""
from __future__ import annotations

from repro_torch.models.transformer import ModelConfig

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
