"""Model components of the port: norms, RoPE, attention, the decoder."""
