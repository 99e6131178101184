"""The port's own copies of DeServe's planning math against the JAX
package's: the §4.3 scheduler (``repro_torch.core.scheduler``), the §3
cost model and the Table 4 simulator.  All of it is host arithmetic, so
the two packages must agree exactly; the one deliberate difference is
``plan_schedule``'s default swap bandwidth (the paper's PCIe rate in the
port, the TPU host-DMA rate in the reference).
"""

import dataclasses

import pytest

from repro.core import cost_model as JCM
from repro.core import scheduler as JSC
from repro.core import simulator as JSIM
from repro_torch.core import cost_model as TCM
from repro_torch.core import offload as TOF
from repro_torch.core import scheduler as TSC
from repro_torch.core import simulator as TSIM

# (n_stages, stage_time, latency): the cases of tests/test_core.py and a
# grid around them
GRID = [(4, 1.0, 0.5), (8, 0.1, 0.0), (8, 0.1, 0.1), (4, 0.01, 1.0),
        (2, 0.1, 0.02), (2, 0.1, 0.05), (8, 0.08, 0.064), (3, 0.0, 0.1),
        (16, 0.25, 0.7), (5, 0.03, 0.0)]


@pytest.mark.parametrize("n,ts,lat", GRID)
def test_optimal_microbatches_and_bubbles_match_jax(n, ts, lat):
    assert TSC.optimal_microbatches(n, ts, lat) == \
        JSC.optimal_microbatches(n, ts, lat)
    for n_b in (n, n + 1, 2 * n, 3 * n + 1):
        if ts > 0:
            assert TSC.bubble_fraction(n, n_b, ts, lat) == \
                JSC.bubble_fraction(n, n_b, ts, lat)
    ps = (TSC.PipelineSchedule(n, n + 2, ts, lat),
          JSC.PipelineSchedule(n, n + 2, ts, lat))
    assert ps[0].round_trip == ps[1].round_trip
    assert [ps[0].microbatch_at(s, t) for s in range(n) for t in range(9)] \
        == [ps[1].microbatch_at(s, t) for s in range(n) for t in range(9)]
    if ts > 0:
        assert ps[0].steady_tick == ps[1].steady_tick
        assert ps[0].utilisation() == ps[1].utilisation()


PLANS = [
    # tests/test_core.py: offload beats no offload at latency
    dict(n_stages=8, stage_time=0.08, latency=0.064, m_kv_bytes=2e9,
         kv_bytes_per_seq=15.7e6, offload_bandwidth=6e9),
    # tests/test_backend.py:122: the cap binds past N_B*
    dict(n_stages=4, stage_time=0.01, latency=1.0, m_kv_bytes=1e9,
         kv_bytes_per_seq=1e6, max_microbatches=16, offload_bandwidth=24e9),
    # per-link latencies of one sum plan alike
    dict(n_stages=4, stage_time=0.08, link_latencies=[0.016, 0.0, 0.0, 0.24],
         m_kv_bytes=2e9, kv_bytes_per_seq=15.7e6, offload_bandwidth=6e9),
    # full-width yi-9b on one H100 (the shape chip_smoke.py plans)
    dict(n_stages=2, stage_time=0.02, latency=0.064, m_kv_bytes=4 * 2 ** 30,
         kv_bytes_per_seq=64 * 1572864, offload_bandwidth=25e9,
         max_microbatches=16),
    dict(n_stages=2, stage_time=0.1, latency=0.02, m_kv_bytes=3e8,
         kv_bytes_per_seq=1e7, offload_bandwidth=2e8, host_kv_bytes=1e9),
]


@pytest.mark.parametrize("kw", PLANS)
@pytest.mark.parametrize("use_offload", [True, False])
def test_plan_schedule_matches_jax(kw, use_offload):
    got = TSC.plan_schedule(use_offload=use_offload, **kw)
    want = JSC.plan_schedule(use_offload=use_offload, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total_batch == want.total_batch


def test_plan_schedule_defaults_to_the_paper_pcie_rate():
    kw = dict(n_stages=8, stage_time=0.08, latency=0.064, m_kv_bytes=2e9,
              kv_bytes_per_seq=15.7e6)
    assert TOF.PCIE4_BW == 24e9
    assert dataclasses.asdict(TSC.plan_schedule(**kw)) == \
        dataclasses.asdict(JSC.plan_schedule(offload_bandwidth=TOF.PCIE4_BW,
                                             **kw))


@pytest.mark.parametrize("call", [
    lambda m: m.optimal_microbatches(4, 1.0, link_latencies=[0.5] * 3),
    lambda m: m.bubble_fraction(4, 4, 1.0, link_latencies=[0.1, -0.1, 0, 0]),
    lambda m: m.plan_schedule(n_stages=4, stage_time=0.1, latency=0.0,
                              m_kv_bytes=1e6, kv_bytes_per_seq=1e9),
    lambda m: m.plan_schedule(n_stages=4, stage_time=0.01, latency=0.0,
                              m_kv_bytes=1e9, kv_bytes_per_seq=1e6,
                              max_microbatches=2),
])
def test_scheduler_refusals_match_jax(call):
    with pytest.raises(ValueError) as want:
        call(JSC)
    with pytest.raises(ValueError) as got:
        call(TSC)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,n_b,lat", [(4, 6, 0.5), (4, 4, 0.5), (2, 3, 0.0),
                                       (3, 5, 1.25)])
def test_schedule_diagram_matches_jax(n, n_b, lat):
    assert TSC.schedule_diagram(n, n_b, stage_time=1.0, latency=lat,
                                ticks=24) == \
        JSC.schedule_diagram(n, n_b, stage_time=1.0, latency=lat, ticks=24)


def test_cost_model_table2_matches_jax_on_the_paper_rows():
    got, want = TCM.table2(), JCM.table2()
    assert set(got) == set(TCM.PAPER_TABLE2) == {"cloud", "runpod",
                                                 "ionet", "mining"}
    for name in TCM.PAPER_TABLE2:
        assert got[name] == want[name]
        tps = got[name]["min_throughput_tps"]
        assert abs(tps - TCM.PAPER_TABLE2[name]) / tps < 0.01
    assert TCM.PAPER_TABLE2 == JCM.PAPER_TABLE2
    for tps in (100.0, 450.0, 5000.0):
        for name, p in TCM.PLATFORMS.items():
            assert TCM.profit_per_hour(tps, p.cost_per_hour) == \
                JCM.profit_per_hour(tps, p.cost_per_hour)
            assert TCM.is_profitable(tps, name) == \
                JCM.is_profitable(tps, name)


@pytest.fixture(scope="module")
def scale():
    got, want = TSIM.calibrate(), JSIM.calibrate()
    assert got == want
    return got


def test_simulator_calibration_matches_jax(scale):
    assert 0.05 < scale < 50.0


def test_simulator_table4_matches_jax(scale):
    got = TSIM.table4(time_scale=scale, sim_seconds=300, warmup=60)
    want = JSIM.table4(time_scale=scale, sim_seconds=300, warmup=60)
    for policy in want:
        for lat in want[policy]:
            assert dataclasses.asdict(got[policy][lat]) == \
                dataclasses.asdict(want[policy][lat]), (policy, lat)
    # the paper's headline: DeServe(opt) beats both baselines at latency
    for lat in (0.016, 0.032, 0.064):
        assert got["vllm_pp"][lat].output_tps < \
            got["deserve_pp"][lat].output_tps < \
            got["deserve_opt"][lat].output_tps


def test_simulator_links_and_stage_time_match_jax(scale):
    lats = (0.016, 0.0, 0.0, 0.24)
    for policy in ("vllm_pp", "deserve_pp", "deserve_opt"):
        assert dataclasses.asdict(TSIM.simulate_links(
            policy, lats, time_scale=scale, sim_seconds=200, warmup=50)) == \
            dataclasses.asdict(JSIM.simulate_links(
                policy, lats, time_scale=scale, sim_seconds=200, warmup=50))
    for b in (1, 3, 16, 100, 256, 600):
        assert TSIM.stage_time(b, scale) == JSIM.stage_time(b, scale)
