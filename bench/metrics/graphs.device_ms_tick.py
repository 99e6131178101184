"""Device ms a decode call: the device operations that start inside the
traced slice's ``bench.decode`` spans, over the number of those spans.
From the profiler's trace."""


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    spans = [s for s in tl.spans_named("bench.decode")
             if s[0] >= tl.t0 and s[1] <= tl.t1]
    if not spans:
        return None
    busy = tl.device_s_within(spans)
    if busy <= 0.0:
        return None
    return 1e3 * busy / len(spans)
