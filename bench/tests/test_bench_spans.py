"""The program's spans on the device's timeline (``bench/spans.py``) and
their readers, against numbers worked by hand on a synthetic recorder
and timeline; and one short run of the tiny cell on the CPU."""

import pytest

from bench import spans as S
from bench import spec
from bench import timeline as T
from bench.serve import Call, Phase
from repro_torch.obs import TraceRecorder

BASE = 1_790_000_000_000_000_000


class Run:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def recorder(steps):
    """A recorder whose wall clock maps ``t`` to ``BASE + t`` seconds, with
    ``steps``: ``(t0, [(track, name, t0, t1, data)...], t1)`` a step."""
    rec = TraceRecorder()
    rec.anchor = (0.0, BASE)
    for i, (t0, inner, t1) in enumerate(steps):
        for track, name, a, b, data in inner:
            rec.span(name, track, a, b, data=data)
        rec.step_phase("reap", t0, t0 + 0.1, i)
    return rec


# one step: reap [0, 0.1], prefill [0.1, 0.3] (build_chunk, the chunk's
# three parts, apply_prefill), decode [0.3, 1.0] (the call's four parts,
# apply_decode), all on the wall clock
STEP = (0.0, [
    ("engine/host", "build_chunk", 0.1, 0.12, ()),
    ("backend", "prefill.inputs", 0.12, 0.13, ()),
    ("backend", "prefill.launch", 0.13, 0.15, ()),
    ("backend", "prefill.wait", 0.15, 0.25, ()),
    ("engine/host", "apply_prefill", 0.25, 0.3, ()),
    ("backend", "decode.inputs", 0.32, 0.34, ()),
    ("backend", "decode.noise", 0.34, 0.44, (("rows", 3),)),
    ("backend", "decode.launch", 0.44, 0.5, ()),
    ("backend", "decode.readout", 0.5, 0.9, ()),
    ("engine/host", "apply_decode", 0.9, 0.95, (("pushes", 0),)),
], 1.0)


def with_phases(rec):
    rec.step_phase("prefill", 0.1, 0.3, 0)
    rec.step_phase("decode", 0.3, 1.0, 0)
    return rec


def timeline():
    """One card busy [0.14, 0.26] and [0.46, 0.88]; the slice [0, 1.2]."""
    tl = T.Timeline(t0=0.0, t1=1.2)
    tl.ops = {0: [(0.14, 0.26, "chunk"), (0.46, 0.88, "decode")]}
    tl.spans = [(0.0, 1.2, "bench.traced"),
                (-0.00001, 1.00001, "bench.step")]
    return tl


def test_the_anchor_lays_spans_on_the_trace():
    rec = with_phases(recorder([STEP]))
    laid = S.on_timeline(rec, BASE - 2_000_000_000)
    assert laid[0] == (pytest.approx(2.0), pytest.approx(2.1), "reap")
    names = [n for *_, n in S.on_timeline(rec, BASE)]
    assert "decode.noise" in names and "decode" in names


def test_innermost_pieces_tile_the_nesting():
    pieces = S.innermost([(0.0, 1.0, "decode"), (0.2, 0.4, "a"),
                          (0.4, 0.5, "b"), (0.45, 0.6, "c"),
                          (1.5, 2.0, "reap")])
    assert pieces == [(0.0, 0.2, "decode"), (0.2, 0.4, "a"),
                      (0.4, 0.45, "b"), (0.45, 0.5, "c"),
                      (0.5, 1.0, "decode"), (1.0, 1.5, "none"),
                      (1.5, 2.0, "reap")]


def test_idle_by_span_by_hand():
    rec = with_phases(recorder([STEP]))
    tl = timeline()
    idle = S.idle_by_span(tl, S.on_timeline(rec, BASE), 1)
    # idle [0, 0.14]: reap 0.1, build_chunk 0.02, prefill.inputs 0.01,
    # prefill.launch 0.01; [0.26, 0.46]: apply_prefill 0.04, the decode
    # phase 0.02, decode.inputs 0.02, decode.noise 0.1, decode.launch
    # 0.02; [0.88, 1.2]: decode.readout 0.02, apply_decode 0.05, the
    # decode phase 0.05, none 0.2
    want = {"reap": 0.1, "build_chunk": 0.02, "prefill.inputs": 0.01,
            "prefill.launch": 0.01, "apply_prefill": 0.04,
            "decode": 0.02 + 0.05, "decode.inputs": 0.02,
            "decode.noise": 0.1, "decode.launch": 0.02,
            "decode.readout": 0.02, "apply_decode": 0.05, "none": 0.2}
    assert set(idle) == set(want)
    for k, v in want.items():
        assert idle[k] == pytest.approx(v, abs=1e-9), k
    # every idle second lands once
    total = sum(e - s for s, e in tl.idle_gaps(0))
    assert sum(idle.values()) == pytest.approx(total, abs=1e-12)
    # a second card idle throughout: half its slice joins each name's mean
    two = S.idle_by_span(tl, S.on_timeline(rec, BASE), 2)
    assert sum(two.values()) == pytest.approx((total + 1.2) / 2)
    assert two["none"] == pytest.approx((0.2 + 0.2) / 2)


def test_readers_by_hand():
    rec = with_phases(recorder([STEP, (1.0, [
        ("backend", "decode.inputs", 1.32, 1.36, ()),
        ("backend", "decode.noise", 1.36, 1.36, (("rows", 0),)),
        ("backend", "decode.launch", 1.36, 1.4, ()),
        ("backend", "decode.readout", 1.4, 1.6, ()),
        ("engine/host", "apply_decode", 1.6, 1.62, (("pushes", 1),))],
        2.0)]))
    run = Run(spans=rec)
    read = {n: spec.load_reader(n)(run) for n in
            ("decode.inputs_ms", "decode.noise_ms", "decode.wait_ms",
             "engine.host_ms_step")}
    assert read["decode.inputs_ms"] == pytest.approx(1e3 * 0.06 / 2)
    assert read["decode.noise_ms"] == pytest.approx(1e3 * 0.1 / 2)
    assert read["decode.wait_ms"] == pytest.approx(1e3 * 0.6 / 2)
    # reap 0.1 + 0.1, build_chunk 0.02, apply_prefill 0.05, apply_decode
    # 0.05 + 0.02, over two steps
    assert read["engine.host_ms_step"] == pytest.approx(1e3 * 0.34 / 2)
    traced = Run(timeline=timeline(), traced_spans=with_phases(
        recorder([STEP])), base_ns=BASE, cards=1)
    # idle under decode.inputs, decode.noise and decode.launch: 0.14 of
    # the 1.2-second slice
    assert spec.load_reader("idle.decode_host_share")(traced) == \
        pytest.approx(100.0 * 0.14 / 1.2)


@pytest.mark.parametrize("name", ["decode.inputs_ms", "decode.noise_ms",
                                  "decode.wait_ms", "engine.host_ms_step",
                                  "idle.decode_host_share"])
def test_readers_read_nothing_without_a_recorder(name):
    """A run of a program without the spans, or with no recorder."""
    bare = Run(phase=Phase(), traced=None, timeline=timeline(), cards=1)
    assert spec.load_reader(name)(bare) is None
    empty = Run(spans=TraceRecorder(), traced_spans=None, base_ns=None,
                timeline=timeline(), cards=1)
    assert spec.load_reader(name)(empty) is None


def test_clock_check_and_coverage_by_hand():
    rec = with_phases(recorder([STEP]))
    tl = timeline()
    clock = S.clock_check(tl, rec, BASE)
    assert clock["steps"] == 1 and clock["inside_share"] == 1.0
    assert clock["lead_us_median"] == pytest.approx(10.0)
    # the harness stamped its step 4 µs before the span opened, and the
    # reap started 6 µs after the stamp
    m = S.mapping_check(tl, rec, BASE, [(-0.000014, 1.0)])
    assert m["steps"] == 1
    assert m["offset_us_median"] == pytest.approx(4.0)
    lead = S.host_lead(rec, [(-0.000006, 1.0), (5.0, 6.0)])
    assert lead == {"steps": 1, "lead_us_median": pytest.approx(6.0),
                    "lead_us_max": pytest.approx(6.0)}
    tl.spans = [(0.5, 0.6, "bench.step")]
    assert S.clock_check(tl, rec, BASE)["inside_share"] == 0.0
    cov = S.coverage([Call(0.31, 0.91, 4, 4, 0, 0),
                      Call(0.31, 0.41, 4, 4, 0, 0)], rec)
    assert cov["calls"] == 2
    assert cov["min"] == pytest.approx(0.09 / 0.1)
    assert cov["median"] == pytest.approx((0.58 / 0.6 + 0.9) / 2)
    assert cov["share_at_least_95"] == 0.5
    split = S.host_split(rec)
    assert split["decode_call_ms"]["decode.readout"] == pytest.approx(400.0)
    assert split["step_ms"]["decode"] == pytest.approx(700.0)


def test_the_tiny_cell_on_the_cpu(tmp_path):
    """The command's collection on the CPU: every span metric but the
    card's idle share reads a number, the decode calls' spans cover their
    host time, and each ``reap`` falls inside a ``bench.step``."""
    from bench.tests.tiny import tiny_cell
    cell = tiny_cell(tmp_path)
    out = S.collect(cell, 2**31 + 11, 0.0, 0.5, "cpu", tmp_path)
    m = out["metrics"]
    for name in ("decode.inputs_ms", "decode.noise_ms", "decode.wait_ms",
                 "engine.host_ms_step"):
        assert m[name] is not None and m[name] > 0.0, name
    assert m["idle.decode_host_share"] is None      # no device operations
    assert out["coverage"]["min"] > 0.5
    assert out["clock"]["inside_share"] == 1.0
    assert out["clock_mapping"]["steps"] == out["steps"]["traced"]
    assert out["clock_host_lead"]["steps"] == out["steps"]["stretch"]
    assert out["recorder"]["dropped"] == 0
    assert out["split"]["steps"] == out["steps"]["stretch"]
