"""Mixtral 8x7B [arXiv:2401.04088]: 32L, d_model 4096, 32 heads (GQA kv=8),
d_ff 14336 per expert, vocab 32000, 8 experts top-2, sliding-window
attention (W=4096)."""
from repro_torch.configs.base import register
from repro_torch.models.moe import MoEDims
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x7b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    pattern=("swa",), window=4096,
    moe=MoEDims(n_experts=8, top_k=2, d_ff=14336, group_size=1024),
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512,
    pattern=("swa",), window=64,
    moe=MoEDims(n_experts=4, top_k=2, d_ff=512, group_size=64),
    chunk_q=32, remat=False,
)

register("mixtral-8x7b", FULL, SMOKE, "arXiv:2401.04088")
