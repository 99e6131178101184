"""The serving benchmark of ``repro_torch`` (see ``bench/README.md``).

Nothing here imports JAX or the JAX package; ``run.py`` checks that no
such module is loaded once a run's window has closed.
"""
