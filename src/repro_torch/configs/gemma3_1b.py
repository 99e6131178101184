"""Gemma3-1B — dense decoder, 5:1 local:global attention, 128k-class context.

[arXiv:2503.19786; hf:google/gemma-3-1b-pt]
"""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    block_pattern=("local",) * 5 + ("global",),
    window_size=512,
    rope_theta=1000000.0,      # global layers; local layers use 10k (model.py)
    tie_embeddings=True,
    scale_embeddings=True,
    logit_softcap=0.0,
    use_qk_norm=True,
    max_position_embeddings=131072,
    source="[arXiv:2503.19786; hf:google/gemma-3-1b-pt]",
))
