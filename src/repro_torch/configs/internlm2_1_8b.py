"""InternLM2-1.8B [arXiv:2403.17297]: 24L, d_model 2048, 16 heads (GQA
kv=8), d_ff 8192, vocab 92544."""
from repro_torch.configs.base import register
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="internlm2-1.8b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92544,
    pattern=("attn",),
)

SMOKE = ModelConfig(
    name="internlm2-1.8b-smoke",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
    d_ff=512, vocab_size=512,
    pattern=("attn",), chunk_q=32, remat=False,
)

register("internlm2-1.8b", FULL, SMOKE, "arXiv:2403.17297")
