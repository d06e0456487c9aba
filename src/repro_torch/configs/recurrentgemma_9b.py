"""RecurrentGemma 9B [arXiv:2402.19427 Griffin / 2404.07839]: 38L hybrid,
d_model 4096, pattern = 2 RG-LRU recurrent blocks : 1 local attention block
(window 2048), 16 heads head_dim 256 MQA (kv=1), GeGLU d_ff 12288,
lru_width 5632, vocab 256000. 38 = 12 full (rec,rec,attn) groups + 2
trailing recurrent layers."""
from repro_torch.configs.base import register
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-9b",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    activation="gelu", gated_mlp=True,
    pattern=("rglru", "rglru", "local_attn"), local_window=2048,
    d_rnn=5632, embed_scale=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke",
    n_layers=3, d_model=256, n_heads=4, n_kv_heads=1, head_dim=64,
    d_ff=512, vocab_size=512,
    activation="gelu", gated_mlp=True,
    pattern=("rglru", "rglru", "local_attn"), local_window=32,
    d_rnn=320, embed_scale=True, chunk_q=32, remat=False,
)

register("recurrentgemma-9b", FULL, SMOKE, "arXiv:2402.19427")
