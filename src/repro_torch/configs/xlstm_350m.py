"""xLSTM-350M [arXiv:2405.04517]: 24 blocks alternating mLSTM (matrix
memory, parallel form) and sLSTM (scalar memory, sequential), d_model 1024,
4 heads, no separate FFN (d_ff=0 — blocks carry their own projections),
vocab 50304 (GPT-NeoX tokenizer rounding)."""
from repro_torch.configs.base import register
from repro_torch.models.transformer import ModelConfig
from repro_torch.models.xlstm import XLSTMDims

FULL = ModelConfig(
    name="xlstm-350m",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab_size=50304,
    pattern=("mlstm", "slstm"),
    xlstm=XLSTMDims(n_heads=4, head_dim=512, up_factor=2),  # d_inner = 2048
)

SMOKE = ModelConfig(
    name="xlstm-350m-smoke",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
    d_ff=0, vocab_size=512,
    pattern=("mlstm", "slstm"),
    xlstm=XLSTMDims(n_heads=4, head_dim=128, up_factor=2),
    chunk_q=32, remat=False,
)

register("xlstm-350m", FULL, SMOKE, "arXiv:2405.04517")
