"""Yi-6B [arXiv:2403.04652]: llama-arch GQA. 32L, d_model 4096, 32 heads
(GQA kv=4), d_ff 11008, vocab 64000."""
from repro_torch.configs.base import register
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="yi-6b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000,
    pattern=("attn",), rope_theta=5e6,
)

SMOKE = ModelConfig(
    name="yi-6b-smoke",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512,
    pattern=("attn",), chunk_q=32, remat=False,
)

register("yi-6b", FULL, SMOKE, "arXiv:2403.04652")
