"""Gemma3-12B — dense decoder, 5:1 local:global attention, 128k-class context.

[arXiv:2503.19786; hf:google/gemma-3-12b-pt]
"""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    block_pattern=("local",) * 5 + ("global",),
    window_size=1024,
    rope_theta=1000000.0,      # global layers; local layers use 10k (model.py)
    tie_embeddings=True,
    scale_embeddings=True,
    use_qk_norm=True,
    max_position_embeddings=131072,
    source="[arXiv:2503.19786; hf:google/gemma-3-12b-pt]",
))
