"""The decentralised marketplace of §6 (own copies of ``repro.framework``):
the task and GPU registries with pipeline matching and the region latency
table the deployment plans read (``registry``), escrow payments
(``payment``), and signature-based arbitration under the paper's three
design principles (``arbitration``)."""
