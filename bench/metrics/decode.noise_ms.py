"""Host ms a decode call spends drawing the sampled rows' Gumbel noise
(the program's ``decode.noise`` span, one a call, no time where no row
samples), the mean over the recorder-only stretch's decode calls
(``run.spans``, ``bench/spans.py``)."""

from bench import spans


def read(run):
    return spans.per_call_ms(getattr(run, "spans", None), "decode.noise")
