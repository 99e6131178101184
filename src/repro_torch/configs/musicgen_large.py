"""MusicGen-Large — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf]  The audio frontend (EnCodec codebook interleaving)
is a stub: the caller supplies precomputed frame embeddings
(``{"frames": (B, S, d_model)}``, ``models.model.embed_inputs``).
"""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,          # MHA (GQA kv=32)
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,          # EnCodec codebook size
    block_pattern=("attn",),
    rope_theta=10000.0,
    frontend="audio_frames",
    tie_embeddings=False,
    max_position_embeddings=32768,
    source="[arXiv:2306.05284; hf]",
))
