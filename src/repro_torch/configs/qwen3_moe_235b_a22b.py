"""Qwen3-MoE-235B-A22B — 128-expert top-8 MoE decoder with GQA + qk-norm.

[hf:Qwen/Qwen3-30B-A3B; hf]  d_ff=1536 is the per-expert FFN width.
"""
from repro_torch.config import ModelConfig, MoEConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,                 # per-expert
    vocab_size=151936,
    block_pattern=("attn",),
    moe=MoEConfig(num_experts=128, experts_per_token=8, d_expert=1536,
                  capacity_factor=1.25, normalize_router_weights=True),
    rope_theta=1000000.0,
    use_qk_norm=True,
    max_position_embeddings=40960,
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
))
