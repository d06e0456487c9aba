"""Gemma 7B [arXiv:2403.08295]: 28L, d_model 3072, 16 heads (MHA kv=16),
head_dim 256, GeGLU d_ff 24576, vocab 256000, sqrt(d) embedding scaling."""
from repro_torch.configs.base import register
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="gemma-7b",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000,
    activation="gelu", gated_mlp=True,   # GeGLU
    pattern=("attn",), embed_scale=True,
)

SMOKE = ModelConfig(
    name="gemma-7b-smoke",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=512,
    activation="gelu", gated_mlp=True,
    pattern=("attn",), embed_scale=True, chunk_q=32, remat=False,
)

register("gemma-7b", FULL, SMOKE, "arXiv:2403.08295")
