"""Atomic, resumable checkpoints (counterpart of ``repro.checkpoint``)."""
