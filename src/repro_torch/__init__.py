"""PyTorch / CUDA port of the DeServe reproduction (``repro``).

The package mirrors ``repro``'s layout and names so each module has an
obvious counterpart, but it imports nothing of ``repro`` and nothing of
JAX: what it needs from the JAX package's jax-free modules it keeps as its
own copy.  Entry points (``serving.llm.LLM``, ``serving.engine.
OfflineEngine``, ``launch.serve``) run on ``cuda`` unless the caller asks
for ``device="cpu"``; on a CPU tensor each kernel wrapper takes its plain
PyTorch version, on a CUDA tensor it launches the hand-written kernel or
raises.
"""
