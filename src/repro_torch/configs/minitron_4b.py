"""Minitron-4B — width/depth-pruned Nemotron dense decoder.

[arXiv:2407.14679; hf]
"""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    block_pattern=("attn",),
    rope_theta=10000.0,
    max_position_embeddings=4096,
    source="[arXiv:2407.14679; hf]",
))
