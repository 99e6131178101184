"""Yi-9B — llama-architecture dense decoder with GQA.

[arXiv:2403.04652; hf]
"""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    block_pattern=("attn",),
    rope_theta=5000000.0,
    max_position_embeddings=4096,
    source="[arXiv:2403.04652; hf]",
))
