"""Registered architectures of the port (one module per arch)."""
