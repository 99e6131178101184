"""Llama-3-70B — the paper's own serving target (DeServe §2, Table 4).

[arXiv:2407.21783; hf]  Used by the paper-reproduction benchmarks (cost
model, batch-size curve, throughput-vs-latency) and as an 11th selectable
arch.
"""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="llama3-70b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    block_pattern=("attn",),
    rope_theta=500000.0,
    max_position_embeddings=8192,
    source="[arXiv:2407.21783; hf]",
))
