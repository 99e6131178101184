"""Host ms a decode call spends on its inputs: the packed host array and
its copies into the captured step's static inputs (the program's
``decode.inputs`` span, one a call), the mean over the recorder-only
stretch's decode calls (``run.spans``, ``bench/spans.py``)."""

from bench import spans


def read(run):
    return spans.per_call_ms(getattr(run, "spans", None), "decode.inputs")
