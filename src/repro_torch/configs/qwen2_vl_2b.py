"""Qwen2-VL-2B — VLM backbone with M-RoPE; dynamic-resolution vision stubbed.

[arXiv:2409.12191; hf]  The caller provides precomputed patch embeddings
(``{"tokens", "patches"}``); the backbone prepends them to the text token
stream and applies M-RoPE (temporal/height/width position components).
"""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    block_pattern=("attn",),
    rope_theta=1000000.0,
    frontend="vision_patches",
    num_patch_tokens=256,      # one 16x16 grid of merged patches per request
    tie_embeddings=True,
    max_position_embeddings=32768,
    source="[arXiv:2409.12191; hf]",
))
