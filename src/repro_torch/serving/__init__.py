"""Offline serving: engine, local backend, paged KV pools, sampling."""
