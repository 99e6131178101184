"""Host ms a step the engine spends on its own books: ``reap`` and the
``engine/host`` spans (``build_chunk``, ``apply_prefill``,
``apply_decode``), over the recorder-only stretch's steps (``run.spans``,
``bench/spans.py``)."""

from bench import spans


def read(run):
    return spans.host_ms_step(getattr(run, "spans", None))
