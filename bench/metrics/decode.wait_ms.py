"""Host ms a decode call waits for its tokens: from the readout's call
until the tokens and log-probs are on the host (the program's
``decode.readout`` span, one a call), the mean over the recorder-only
stretch's decode calls (``run.spans``, ``bench/spans.py``)."""

from bench import spans


def read(run):
    return spans.per_call_ms(getattr(run, "spans", None), "decode.readout")
