"""DeepSeek 67B [arXiv:2401.02954]: llama-arch. 95L, d_model 8192, 64 heads
(GQA kv=8), d_ff 22016, vocab 102400."""
from repro_torch.configs.base import register
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="deepseek-67b",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=102400,
    pattern=("attn",),
)

SMOKE = ModelConfig(
    name="deepseek-67b-smoke",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512,
    pattern=("attn",), chunk_q=32, remat=False,
)

register("deepseek-67b", FULL, SMOKE, "arXiv:2401.02954")
