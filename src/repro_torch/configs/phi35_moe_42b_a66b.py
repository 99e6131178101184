"""Phi-3.5-MoE-42B-A6.6B — 16-expert top-2 MoE decoder.

[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from repro_torch.config import ModelConfig, MoEConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,                 # per-expert
    vocab_size=32064,
    block_pattern=("attn",),
    moe=MoEConfig(num_experts=16, experts_per_token=2, d_expert=6400,
                  capacity_factor=1.25, normalize_router_weights=False),
    rope_theta=10000.0,
    max_position_embeddings=131072,
    source="[hf:microsoft/Phi-3.5-MoE-instruct; hf]",
))
