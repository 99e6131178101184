"""The port's inter-stage links, deployment plans, registry and int8 wire
codec (``repro_torch.distributed``, ``repro_torch.framework.registry``)
against the JAX package's.

Transports and registry are numpy / plain Python in both packages, so
they run in this process: one recorded tick sequence goes through both
packages' ``InProcessTransport``, ``SimulatedLinkTransport`` (with jitter
and a seed) and ``CompressedTransport`` (int8 and top-k); every tick's
observations and the final books must be equal, and ``audit()`` must
pass.  The int8 row codec must be bit-exact against ``jnp`` on the same
float32 rows, the awkward ones included.  ``EngineConfig.plan`` with a
deployment must reach the same schedule and prefill chunk.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import reduced_config as jax_reduced  # noqa: E402
from repro.distributed import compression as JC  # noqa: E402
from repro.distributed import transport as JT  # noqa: E402
from repro.framework import registry as JR  # noqa: E402
from repro.models.common import Runtime as JaxRuntime  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import llm as jax_llm  # noqa: E402
from repro_torch.config import get_arch, reduced_config  # noqa: E402
from repro_torch.distributed import compression as TC  # noqa: E402
from repro_torch.distributed import transport as TT  # noqa: E402
from repro_torch.framework import registry as TR  # noqa: E402
from repro_torch.models.common import Runtime  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serving import engine as port_engine  # noqa: E402
from repro_torch.serving import llm  # noqa: E402

N_STAGES = 3
PAYLOADS = (4096, 8192, 65536, 3)       # raw bytes of a tick's payload


def tick_sequence(seed: int = 0, n: int = 80):
    """A recorded mix of decode and prefill ticks on a 3-stage ring:
    occupancy, payload, per-stage compute seconds, injection time."""
    rng = np.random.RandomState(seed)
    seq = []
    for _ in range(n):
        occ = list(rng.rand(N_STAGES) < 0.7)
        seq.append(dict(occupied=occ,
                        nbytes=int(PAYLOADS[rng.randint(len(PAYLOADS))]),
                        compute_s=list(rng.uniform(0.001, 0.03, N_STAGES)),
                        inject_t=float(rng.uniform(0, 0.5)) if occ[0]
                        else 0.0,
                        plane="decode" if rng.rand() < 0.7 else "prefill"))
    return seq


def links(pkg):
    return [pkg.LinkSpec(0.064, 1e6, 0.01), pkg.LinkSpec(0.002, 0.0, 0.0),
            pkg.LinkSpec(0.140, 5e5, 0.02)]


TRANSPORTS = {
    "inprocess": lambda pkg: pkg.InProcessTransport().bind(N_STAGES),
    "simulated": lambda pkg: pkg.SimulatedLinkTransport(
        links(pkg), seed=5).bind(N_STAGES),
    "simulated-fixed-stage": lambda pkg: pkg.SimulatedLinkTransport(
        links(pkg), stage_time_s=0.016, seed=1).bind(N_STAGES),
    "compressed-int8": lambda pkg: pkg.CompressedTransport(
        pkg.SimulatedLinkTransport(links(pkg), seed=5), method="int8",
        elem_bytes=2, row_elems=1024).bind(N_STAGES),
    "compressed-topk": lambda pkg: pkg.CompressedTransport(
        pkg.SimulatedLinkTransport(links(pkg), seed=2), method="topk",
        topk_frac=0.05).bind(N_STAGES),
    "uniform": lambda pkg: pkg.SimulatedLinkTransport.uniform(
        N_STAGES, 0.064, bandwidth_bps=2e6, jitter_s=0.005, seed=9),
}


@pytest.mark.parametrize("kind", list(TRANSPORTS))
def test_transport_books_match_jax(kind):
    jt, tt = TRANSPORTS[kind](JT), TRANSPORTS[kind](TT)
    for t in tick_sequence():
        jo, to = jt.tick(**t), tt.tick(**t)
        np.testing.assert_array_equal(to.stalls, jo.stalls)
        assert (to.drain_done, to.return_ready) == \
            (jo.drain_done, jo.return_ready)
    assert tt.stats() == jt.stats()
    tt.audit()
    jt.audit()


def test_resized_transport_matches_jax():
    """``for_stages`` keeps the books and the slowest link's envelope."""
    jt, tt = TRANSPORTS["simulated"](JT), TRANSPORTS["simulated"](TT)
    for t in tick_sequence(n=20):
        jt.tick(**t)
        tt.tick(**t)
    jt, tt = jt.for_stages(2), tt.for_stages(2)
    for t in tick_sequence(seed=1, n=20):
        t = dict(t, occupied=t["occupied"][:2],
                 compute_s=t["compute_s"][:2])
        assert tt.tick(**t).return_ready == jt.tick(**t).return_ready
    assert tt.stats() == jt.stats()


@pytest.mark.parametrize("kind", [None, "inprocess", 0.032])
def test_make_transport_matches_jax(kind):
    jt, tt = JT.make_transport(kind, 2), TT.make_transport(kind, 2)
    assert type(tt).__name__ == type(jt).__name__
    assert tt.stats() == jt.stats()


# ------------------------------------------------------------- deployments

REGION_SETS = [["us-west", "us-east", "eu"],
               ["eu", "us-west", "eu", "us-east"],
               ["us-east", "mars", "us-west", "eu", "us-east"]]


@pytest.mark.parametrize("regions", REGION_SETS)
def test_deployment_plan_matches_jax(regions):
    kw = dict(bandwidth_bps=1e7, jitter_s=0.003)
    jp = JT.DeploymentPlan.from_regions(regions, **kw)
    tp = TT.DeploymentPlan.from_regions(regions, **kw)
    np.testing.assert_array_equal(tp.latency_matrix, jp.latency_matrix)
    for a, b in ((tp, jp), (tp.place_stages(), jp.place_stages()),
                 (tp.place_stages([1.0, 3.0] + [1.0] * (len(regions) - 2)),
                  jp.place_stages([1.0, 3.0] + [1.0] * (len(regions) - 2)))):
        assert a.stages == b.stages and a.regions == b.regions
        assert a.link_latencies == b.link_latencies
        assert dataclasses.astuple(a.worst_link) == \
            dataclasses.astuple(b.worst_link)
        assert a.max_link_latency == b.max_link_latency
        assert a.max_pairwise_latency == b.max_pairwise_latency
        assert a.describe() == b.describe()
    for t in tick_sequence(n=30):
        n = len(regions)
        t = dict(t, occupied=(t["occupied"] * 2)[:n],
                 compute_s=(t["compute_s"] * 2)[:n])
        jo = jp.transport(seed=4).tick(**t)
        to = tp.transport(seed=4).tick(**t)
        assert to.return_ready == jo.return_ready


def _registries():
    regs = (JR.Registry(), TR.Registry())
    for reg in regs:
        for i, (region, gib) in enumerate([
                ("us-west", 24), ("us-east", 80), ("eu", 40), ("us-west", 80),
                ("us-east", 24), ("eu", 80), ("us-west", 40)]):
            reg.register_machine(f"miner{i}", gib << 30, region, 1.0 + i)
        reg.register_task("alice", "yi-9b", 120 << 30, 1000, 0.5)
    return regs


def test_registry_match_and_plan_match_jax():
    jr, tr = _registries()
    jm, tm = jr.match(0), tr.match(0)
    assert [m.machine_id for m in tm.machines] == \
        [m.machine_id for m in jm.machines]
    assert tm.max_latency == jm.max_latency
    jp = JT.DeploymentPlan.from_match(jm)
    tp = TT.DeploymentPlan.from_match(tm)
    assert tp.stages == jp.stages and tp.link_latencies == jp.link_latencies


# ------------------------------------------------------------- int8 codec

def codec_rows():
    rng = np.random.RandomState(0)
    big = np.finfo(np.float32).max
    rows = [rng.standard_normal(64) * s for s in (1e-3, 1.0, 1e3)]
    rows += [np.zeros(64), np.full(64, 0.5),
             np.linspace(-1.0, 1.0, 64) * big, np.full(64, big * 0.999),
             np.r_[np.nan, rng.standard_normal(63)],
             np.r_[np.inf, -np.inf, rng.standard_normal(62)],
             np.r_[[np.inf] * 32, [-np.inf] * 32],
             np.full(64, np.nan), np.full(64, 1e-40)]
    # values at half-steps of the scale: round half to even
    rows.append(np.arange(-64, 64, 2) / 2.0 * (3.0 / 127.0))
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("shape", [(13, 64), (13, 4, 16)])
def test_int8_codec_is_bit_exact_against_jax(shape):
    x = codec_rows().reshape(shape[0], -1)
    x = x.reshape(shape) if len(shape) == 2 else \
        np.repeat(x[:, None, :16], 4, axis=1)
    jq, js = JC.int8_compress_rows(jnp.asarray(x))
    tq, ts = TC.int8_compress_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    jd = np.asarray(JC.int8_decompress_rows(jq, js))
    td = TC.int8_decompress_rows(tq, ts).numpy()
    np.testing.assert_array_equal(td, jd)
    # the inf cap keeps every row whose finite values stay under it finite
    # (a finite value near float32's maximum may still round past it on
    # the way back, in both packages)
    capped = np.abs(np.nan_to_num(x, posinf=0, neginf=0)).max(-1) <= 3.0e38
    assert np.isfinite(td[capped]).all()


def test_int8_codec_bf16_round_trip_matches_jax():
    x = np.random.RandomState(1).standard_normal((6, 96)).astype(np.float32)
    jy = JC.int8_decompress_rows(*JC.int8_compress_rows(
        jnp.asarray(x, jnp.bfloat16)), jnp.bfloat16)
    ty = TC.int8_decompress_rows(*TC.int8_compress_rows(
        torch.from_numpy(x).bfloat16()), torch.bfloat16)
    np.testing.assert_array_equal(ty.float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))


@pytest.mark.parametrize("n_elems,n_rows", [(4096, 1), (4096 * 4, 4),
                                            (1, 1), (0, 0)])
def test_int8_wire_bytes_match_jax(n_elems, n_rows):
    assert TC.int8_wire_bytes(n_elems, n_rows) == \
        JC.int8_wire_bytes(n_elems, n_rows)


# ------------------------------------------------------------ the planner

@pytest.mark.parametrize("regions", [["us-west", "us-east"],
                                     ["us-west", "eu", "us-east"]])
def test_plan_with_a_deployment_matches_jax(regions):
    """The planner's inputs from a deployment (its stage count, the slowest
    ring link, every link's latency, and the worst link's bandwidth, which
    caps the prefill chunk) give both packages the same schedule, pool and
    chunk.  The JAX engine is built on its local backend (its pipelined
    one needs a host device a stage); the port's on both."""
    import jax
    from repro.models import model as jax_model
    kw = dict(bandwidth_bps=2e5)
    jdep = JT.DeploymentPlan.from_regions(regions, **kw)
    tdep = TT.DeploymentPlan.from_regions(regions, **kw)
    jcfg = jax_reduced(jax_get_arch("yi-9b"), num_layers=6)
    tcfg = reduced_config(get_arch("yi-9b"), num_layers=6)
    plan = dict(stage_time=0.05, m_kv_bytes=1.2e6, page_size=8,
                max_pages_per_seq=8, bandwidth=4e6, mb_size_cap=2,
                max_microbatches=8)
    jrt = JaxRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32)
    trt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
    jeng = jax_llm.EngineConfig.plan(deployment=jdep, **plan).build(
        jcfg, jax_model.init_params(jcfg, jax.random.PRNGKey(0), jrt), jrt)
    tparams = init_params(tcfg, 0, trt, "cpu")
    for backend in ("local", "pipelined"):
        tconf = llm.EngineConfig.plan(deployment=tdep, backend=backend,
                                      **plan)
        teng = tconf.build(tcfg, tparams, trt, device="cpu")
        assert teng.backend.name == backend
        assert teng.n_stages == len(regions)
        assert dataclasses.asdict(teng.schedule_choice) == \
            dataclasses.asdict(jeng.schedule_choice)
        assert dataclasses.asdict(teng.pool) == dataclasses.asdict(jeng.pool)
        assert (teng.mb_size, teng.prefill_chunk, teng.prefill_rows) == \
            (jeng.mb_size, jeng.prefill_chunk, jeng.prefill_rows)
    assert teng.backend.transport.stats()["max_link_latency_s"] == \
        jdep.max_link_latency
    for wire in ("fp32", "int8"):
        assert port_engine.prefill_chunk_cap(
            tcfg, trt, tdep.worst_link, stage_time=0.05,
            wire_dtype=wire) == jax_engine.prefill_chunk_cap(
            jcfg, jrt, jdep.worst_link, stage_time=0.05, wire_dtype=wire)
