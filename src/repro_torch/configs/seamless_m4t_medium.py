"""SeamlessM4T-medium [arXiv:2308.11596]: encoder-decoder, 12 encoder +
12 decoder layers, d_model 1024, 16 heads (MHA kv=16), d_ff 4096, vocab
256206 (padded to 256256 = 16*16016 for tensor sharding).

The speech frontend (mel-spectrogram + conformer feature extractor) is a
stub, as in the reference: the caller provides precomputed frame
embeddings at seq_len // 4 (conv subsampling factor) as ``src_embeds``."""
from repro_torch.configs.base import register
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-medium",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256256,  # 256206 padded
    pattern=("attn",),
    n_enc_layers=12, src_ratio=4,
    frontend="audio",
)

SMOKE = ModelConfig(
    name="seamless-m4t-medium-smoke",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=512, vocab_size=512,
    pattern=("attn",),
    n_enc_layers=2, src_ratio=4,
    frontend="audio", chunk_q=32, remat=False,
)

register("seamless-m4t-medium", FULL, SMOKE, "arXiv:2308.11596")
