"""Model components of the port: norms, RoPE, attention, the Griffin
recurrent block, the mixture-of-experts FFN, the xLSTM blocks, the
decoder."""
