"""InternVL2-26B [arXiv:2404.16821]: InternViT-6B vision encoder +
InternLM2-20B language model. The assignment specifies the language
backbone: 48L, d_model 6144, 48 heads (GQA kv=8), d_ff 16384, vocab 92553
(padded to 92672 = 16*5792 for tensor sharding).

The vision frontend (InternViT + MLP projector) is a STUB per the
assignment: input_specs provides 256 precomputed patch embeddings."""
from repro_torch.configs.base import register
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="internvl2-26b",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92672,  # 92553 padded for model-axis sharding
    pattern=("attn",),
    frontend="vision", n_prefix=256,
)

SMOKE = ModelConfig(
    name="internvl2-26b-smoke",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512,
    pattern=("attn",),
    frontend="vision", n_prefix=16, chunk_q=32, remat=False,
)

register("internvl2-26b", FULL, SMOKE, "arXiv:2404.16821")
