"""``repro_torch.distributed.elastic`` (the port's own copy) against
``repro.distributed.elastic``: fault plans, the failure detector, the
straggler mitigator and the elastic planner give the same answers on the
same inputs.  The sweeps draw event lists, heartbeat sequences and tick
times from a seed (``hypothesis`` where it is installed, the repo's shim
otherwise); everything here is host Python, so equal means equal, floats
included."""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.distributed import elastic as J
from repro_torch.distributed import elastic as T

PLANES = ("decode", "prefill")
KINDS = ("drop", "delay")


def _specs(rng, n):
    """``n`` CLI fault specs: drops and delays, both planes, ticks and
    stages that repeat so that one take can fire several events."""
    out = []
    for _ in range(n):
        kind = KINDS[rng.randint(2)]
        spec = (f"{kind}@{PLANES[rng.randint(2)]}:{rng.randint(12)}:"
                f"{rng.randint(4)}")
        if kind == "delay":
            spec += f":{rng.randint(1, 500) / 1000}"
        out.append(spec)
    return out


def _events(plan):
    return [dataclasses.astuple(e) for e in plan]


def test_fault_plan_parse_take_and_validation():
    fp = T.FaultPlan.parse(["drop@decode:12:1", "delay@prefill:3:0:0.25"])
    assert fp.pending() == 2 and bool(fp)
    assert fp.take("decode", 11) == []
    hit = fp.take("decode", 12)
    assert len(hit) == 1 and hit[0].stage == 1 and hit[0].kind == "drop"
    assert fp.take("decode", 12) == []          # consumed: fires once
    [ev] = fp.take("prefill", 3)
    assert ev.kind == "delay" and ev.delay_s == 0.25
    assert fp.pending() == 0 and not fp
    assert [e.tick for e in fp.triggered] == [12, 3]


@pytest.mark.parametrize("bad", [
    dict(spec="decode:12:1", match="fault spec"),
    dict(spec="drop@decode:x:1", match="fault spec"),
    dict(event=("ring", 0, 0), match="plane"),
    dict(event=("decode", 0, 0, "explode"), match="kind"),
    dict(event=("decode", -1, 0), match=">= 0"),
    dict(event=("decode", 0, -2), match=">= 0"),
], ids=["no-kind", "bad-tick", "plane", "kind", "tick", "stage"])
def test_fault_validation_matches_jax(bad):
    """Both packages refuse the same malformed specs and events, with the
    same message."""
    msgs = []
    for mod in (J, T):
        with pytest.raises(ValueError, match=bad["match"]) as err:
            if "spec" in bad:
                mod.FaultPlan.parse([bad["spec"]])
            else:
                mod.FaultEvent(*bad["event"])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1))
def test_fault_plan_matches_jax(seed):
    """A seeded event list parsed by both packages, then the same sequence
    of ``take`` calls (ticks that hit, miss and repeat): the same events
    fire at the same calls, in the same order, and the same stay
    pending."""
    rng = np.random.RandomState(seed)
    specs = _specs(rng, rng.randint(0, 10))
    jp, tp = J.FaultPlan.parse(specs), T.FaultPlan.parse(specs)
    assert _events(jp.events) == _events(tp.events)
    for _ in range(rng.randint(1, 30)):
        plane, tick = PLANES[rng.randint(2)], int(rng.randint(14))
        assert _events(jp.take(plane, tick)) == _events(tp.take(plane, tick))
        assert jp.pending() == tp.pending() and bool(jp) == bool(tp)
    assert _events(jp.triggered) == _events(tp.triggered)
    assert _events(jp.events) == _events(tp.events)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1))
def test_failure_detector_matches_jax(seed):
    """Heartbeats of a few devices at seeded times, some going silent and
    some coming back (flaps), probed at seeded times, boundary instants
    (``now - last_seen == timeout``) included."""
    rng = np.random.RandomState(seed)
    timeout = float(rng.choice([1.0, 2.5, 5.0]))
    jd, td = J.FailureDetector(timeout), T.FailureDetector(timeout)
    n_dev = rng.randint(1, 6)
    now = 0.0
    for _ in range(rng.randint(1, 40)):
        now += float(rng.choice([0.5, 1.0, timeout, timeout + 0.5]))
        for d in range(n_dev):
            if rng.rand() < 0.7:
                jd.beat(d, now)
                td.beat(d, now)
        probe = now + float(rng.choice([0.0, timeout, timeout + 1.0]))
        assert jd.dead(probe) == td.dead(probe)
        assert jd.live(probe) == td.live(probe)
        req = int(rng.randint(0, n_dev + 2))
        assert jd.should_restart(probe, req) == td.should_restart(probe, req)
    for d in range(n_dev + 1):
        assert jd.flap_count(d) == td.flap_count(d)
    assert jd.flap_count() == td.flap_count()


def test_failure_detector_flaps_and_boundary():
    fd = T.FailureDetector(timeout=2.0)
    fd.beat(0, 0.0)
    fd.beat(1, 0.0)
    assert fd.live(2.0) == [0, 1] and fd.dead(2.0) == []   # boundary: live
    assert fd.dead(2.5) == [0, 1]
    fd.beat(1, 3.0)                     # back after missing the timeout
    assert fd.flap_count(1) == 1 and fd.flap_count(0) == 0
    assert fd.flap_count() == 1 and fd.flap_count(7) == 0
    assert fd.live(3.0) == [1] and fd.should_restart(3.0, required=2)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1))
def test_straggler_mitigator_matches_jax(seed):
    """Seeded stage-time observations (a slow stage sometimes, cold
    stages sometimes): the same EWMAs, median, stragglers, demotions and
    weights after every observation."""
    rng = np.random.RandomState(seed)
    n = int(rng.randint(1, 6))
    kw = dict(alpha=float(rng.choice([0.2, 0.5, 1.0])),
              slow_factor=float(rng.choice([1.2, 1.5])),
              demote_factor=float(rng.choice([2.0, 3.0])))
    jm, tm = J.StragglerMitigator(n, **kw), T.StragglerMitigator(n, **kw)
    slow = int(rng.randint(n))
    for _ in range(rng.randint(1, 60)):
        s = int(rng.randint(n))
        dt = float(rng.uniform(0.01, 0.02)) * (
            float(rng.choice([1.0, 4.0])) if s == slow else 1.0)
        jm.observe(s, dt)
        tm.observe(s, dt)
        assert jm.ewma == tm.ewma
        assert jm.median() == tm.median()
        assert jm.stragglers() == tm.stragglers()
        assert jm.demotions() == tm.demotions()
        assert jm.microbatch_weights() == tm.microbatch_weights()


def test_straggler_flags_a_slow_stage_and_recovers():
    sm = T.StragglerMitigator(4)
    assert sm.microbatch_weights() == [1.0] * 4     # cold: nothing flagged
    for _ in range(5):
        for s in range(3):
            sm.observe(s, 0.1)
        sm.observe(3, 1.0)
    assert sm.stragglers() == [3] and sm.demotions() == [3]
    w = sm.microbatch_weights()
    assert min(w) == w[3] < 1.0 and sum(w) == pytest.approx(4.0)
    for _ in range(50):
        sm.observe(3, 0.1)
    assert sm.stragglers() == []


@pytest.mark.parametrize("mod", [J, T], ids=["jax", "port"])
def test_two_stage_median_flags_nothing(mod):
    """The reference's median is the upper one (``s[len(s) // 2]``): with
    two observed stages it is the slower stage's EWMA, so no stage of a
    two-stage pipe can exceed ``slow_factor`` times it, however slow.  The
    port keeps the reference's rule."""
    sm = mod.StragglerMitigator(2)
    for _ in range(10):
        sm.observe(0, 0.01)
        sm.observe(1, 1.0)
    assert sm.median() == sm.ewma[1]
    assert sm.stragglers() == [] and sm.demotions() == []


@pytest.mark.parametrize("live", [1, 3, 4, 7, 16, 17, 100, 511, 512, 700])
@pytest.mark.parametrize("mp,pod", [(1, 1 << 30), (4, 256), (16, 256)])
def test_elastic_planner_matches_jax(live, mp, pod):
    """Plans for live-device counts around powers of two and pod edges,
    and the resharding plan between consecutive counts."""
    jp, tp = J.ElasticPlanner(mp, pod), T.ElasticPlanner(mp, pod)
    if live < mp:
        for p in (jp, tp):
            with pytest.raises(RuntimeError, match="model parallel"):
                p.plan(live)
        return
    jplan, tplan = jp.plan(live), tp.plan(live)
    assert dataclasses.astuple(jplan) == dataclasses.astuple(tplan)
    assert (jplan.data, jplan.model) == (tplan.data, tplan.model)
    prev = max(mp, live // 2)
    jr = jp.resharding_plan(jp.plan(prev), jplan)
    tr = tp.resharding_plan(tp.plan(prev), tplan)
    strip = ("old", "new")
    assert {k: v for k, v in jr.items() if k not in strip} == \
        {k: v for k, v in tr.items() if k not in strip}
