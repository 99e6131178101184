"""The decentralised marketplace's service discovery (own copy of
``repro.framework.registry``: task and GPU registries, pipeline matching
and the region latency table the deployment plans read)."""
