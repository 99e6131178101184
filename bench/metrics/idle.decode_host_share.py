"""Share of the traced slice in which the card is idle while the host is
in a decode call's ``decode.inputs``, ``decode.noise`` or
``decode.launch`` span, in %, the mean over the cell's cards: the
program's spans of the profiled slice (``run.traced_spans``) laid on the
profiler's trace through the recorder's clock anchor (``run.base_ns``,
``bench/spans.py``)."""

from bench import spans


def read(run):
    idle = spans.traced_idle(run)
    if idle is None:
        return None
    return 100.0 * sum(idle.get(n, 0.0) for n in spans.DECODE_HOST) \
        / run.timeline.window_s
