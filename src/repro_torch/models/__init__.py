"""Model components of the port: norms, RoPE, attention, the Griffin
recurrent block, the decoder."""
