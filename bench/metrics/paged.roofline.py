"""The paged decode kernel's share of its roofline, in %: the least time of
a launch (its K/V bytes read once and its operations, at 3.35 TB/s and
989 TFLOP/s; ``bench.flops.paged_cost``), averaged over the traced slice's
decode calls (one launch a layer, every row of the call at its length),
over the mean device time of the launches the trace shows by the kernel's
name (``paged_split``)."""

from bench import flops


def read(run):
    tl, ph = run.timeline, run.traced
    if tl is None or ph is None or not ph.decode:
        return None
    launches = tl.ops_named("paged_split")
    if not launches:
        return None
    s = run.sizes
    least = 0.0
    for c in ph.decode:
        f, b = flops.paged_cost([c.kernel_toks], 0, s["H"], s["Hk"], s["Dh"],
                                run.esize, c.rows, run.pages_seq)
        least += flops.least_s(f, b, run.dtype_name)
    least_each = least / len(ph.decode)
    time_each = sum(e - b for b, e, _ in launches) / len(launches)
    return 100.0 * least_each / time_each
