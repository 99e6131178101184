"""RecurrentGemma-9B — Griffin: RG-LRU recurrent blocks + local attention, 2:1.

[arXiv:2402.19427 (Griffin); arXiv:2404.07839 (RecurrentGemma);
hf:google/recurrentgemma-9b]  Pattern period is (rglru, rglru, local): two
gated linear-recurrence blocks followed by one sliding-window MQA block.
The JAX package models its MLP as SwiGLU (the published model has a GeGLU
MLP) and keeps the Griffin block's gates, conv and Lambda init as
``repro.models.rglru`` has them; the port mirrors the JAX package.
"""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,           # MQA on the local-attention layers
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"),
    window_size=2048,
    rope_theta=10000.0,
    norm_eps=1e-6,
    tie_embeddings=True,
    scale_embeddings=True,
    logit_softcap=30.0,
    d_rnn=4096,
    conv_width=4,
    max_position_embeddings=8192,
    source="[arXiv:2402.19427; arXiv:2404.07839; hf:google/recurrentgemma-9b]",
))
