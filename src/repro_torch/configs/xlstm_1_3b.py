"""xLSTM-1.3B — sLSTM + mLSTM recurrent blocks (7:1 mLSTM:sLSTM).

[arXiv:2405.04517; unverified]  d_ff=0: xLSTM blocks embed their own
projections; there is no separate FFN sub-block.
"""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    d_rnn=2560,                # 1.25x in-block expansion: lands the
                               # total at the 1.3B name scale
    tie_embeddings=False,
    max_position_embeddings=1 << 20,
    source="[arXiv:2405.04517; unverified]",
))
