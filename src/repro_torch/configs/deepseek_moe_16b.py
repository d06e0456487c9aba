"""DeepSeekMoE 16B [arXiv:2401.06066]: 28L, d_model 2048, 16 heads (MHA
kv=16), fine-grained experts d_ff 1408, vocab 102400, 64 routed experts
top-6 + 2 shared experts; first layer uses a dense FFN (width 10944)."""
from repro_torch.configs.base import register
from repro_torch.models.moe import MoEDims
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="deepseek-moe-16b",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    pattern=("attn",),
    moe=MoEDims(n_experts=64, top_k=6, d_ff=1408, n_shared=2,
                group_size=512),
    first_k_dense=1, first_dense_d_ff=10944,
)

SMOKE = ModelConfig(
    name="deepseek-moe-16b-smoke",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=128, vocab_size=512,
    pattern=("attn",),
    moe=MoEDims(n_experts=4, top_k=2, d_ff=128, n_shared=1, group_size=64),
    first_k_dense=1, first_dense_d_ff=512,
    chunk_q=32, remat=False,
)

register("deepseek-moe-16b", FULL, SMOKE, "arXiv:2401.06066")
