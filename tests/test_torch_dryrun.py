"""The port's dry run (``repro_torch.launch.dryrun``), mesh and kernel cost
formulas against the JAX package's and against what a CPU run counts.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices;
``jax.devices()`` runs first so that this worker keeps its one CPU device.
The JAX dry run's compiles are not run: the tables it builds from shapes
(microbatching, inputs, the long-context skip, meshes) are compared.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax

jax.devices()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import _disable_current_modes  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.distributed.elastic import ElasticPlanner as JPlanner  # noqa: E402
from repro.launch import dryrun as JDR  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import cost, ops, ref  # noqa: E402
from repro_torch.launch import dryrun as TDR  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.common import Runtime  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = tconfig.list_archs()


# ---------------------------------------------------------------------------
# tables the dry run builds from shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", sorted(JDR.VARIANTS))
def test_serve_pipeline_config_matches_jax(variant):
    for name, shape in tconfig.SHAPES.items():
        for n_stages in (2, 4):
            j = JDR.serve_pipeline_config(jconfig.SHAPES[name], n_stages,
                                          variant)
            t = TDR.serve_pipeline_config(shape, n_stages, variant)
            assert (t.n_stages, t.n_microbatches, t.mb_size) == \
                (j.n_stages, j.n_microbatches, j.mb_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_inputs_match_jax(arch):
    for name in tconfig.SHAPES:
        for labels in (False, True):
            j = JDR.batch_inputs(jconfig.get_arch(arch),
                                 jconfig.SHAPES[name], include_labels=labels)
            t = TDR.batch_inputs(tconfig.get_arch(arch),
                                 tconfig.SHAPES[name], include_labels=labels)
            assert sorted(t) == sorted(j)
            for k in j:
                assert tuple(t[k].shape) == j[k].shape
                assert str(t[k].dtype).replace("torch.", "") == \
                    str(j[k].dtype)
                assert t[k].device.type == "meta"


def test_long_500k_skip_matches_jax(tmp_path):
    """JAX skips the 500k decode of every pure full-attention arch; the
    port skips exactly those, with the same record, and traces the rest."""
    for arch in ARCHS:
        skip = not jconfig.get_arch(arch).is_subquadratic()
        if not skip:
            continue
        j = JDR.run_cell(arch, "long_500k", "single_pod",
                         out_dir=str(tmp_path / "jax"))
        t = TDR.run_cell(arch, "long_500k", "single_pod",
                         out_dir=str(tmp_path / "port"))
        assert j["skipped"] and t == j
    kept = [a for a in ARCHS if jconfig.get_arch(a).is_subquadratic()]
    assert kept, "some arch decodes at 500k"
    rec = TDR.run_cell(kept[0], "long_500k", "single_pod",
                       out_dir=str(tmp_path / "port"))
    assert rec["ok"] and not rec["skipped"]


def test_runtime_for_matches_jax_and_refuses_unported_variants():
    """The ported knobs equal JAX's; a variant that sets only XLA SPMD
    knobs (``zero3*``, ``blockpair``, ``opt`` on training) raises."""
    for kind in ("train", "prefill", "decode"):
        for variant in JDR.VARIANTS:
            knobs = TDR.VARIANTS[variant]
            unported = (bool(knobs) and all(
                k in TDR.UNPORTED_KNOBS for k in knobs)) or \
                (variant == "opt" and kind == "train")
            if unported:
                with pytest.raises(NotImplementedError, match="ROADMAP"):
                    TDR.runtime_for(kind, variant)
                continue
            j, t = JDR.runtime_for(kind, variant), TDR.runtime_for(kind,
                                                                   variant)
            assert (t.remat, t.vocab_chunk, t.moe_chunk, t.kv_dtype,
                    t.mlstm_chunk) == (j.remat, j.vocab_chunk, j.moe_chunk,
                                       j.kv_dtype, j.mlstm_chunk)
            assert t.param_dtype == t.compute_dtype == torch.bfloat16
            assert j.param_dtype == j.compute_dtype == jnp.bfloat16
    for variant in ("zero3", "blockpair", "zero3_accum2", "zero3_blockpair",
                    "opt"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TDR.build_cell("gemma3-1b", "train_4k", "single_pod", variant)


def test_meshes_match_jax(monkeypatch):
    """The production meshes and the elastic ones: the shapes and axes the
    JAX package hands ``jax.make_mesh`` (not called here)."""
    monkeypatch.setattr(jmesh.jax, "make_mesh", lambda shape, axes: (
        tuple(shape), tuple(axes)))
    for multi in (False, True):
        t = tmesh.make_production_mesh(multi_pod=multi)
        assert (t.shape, t.axes) == jmesh.make_production_mesh(
            multi_pod=multi)
        assert t.num_devices == (512 if multi else 256)
    for devices in (16, 17, 64, 100, 256, 300, 511, 512, 777, 1024):
        for mp in (4, 16):
            t = tmesh.make_mesh_for(devices, model_parallel=mp)
            assert (t.shape, t.axes) == jmesh.make_mesh_for(
                devices, model_parallel=mp)
            plan = JPlanner(model_parallel=mp).plan(devices)
            assert t.num_devices == plan.devices_used
    with pytest.raises(RuntimeError):
        tmesh.make_mesh_for(8)


# ---------------------------------------------------------------------------
# meta weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_init_params_has_the_cpu_tree(arch):
    cfg = tconfig.reduced_config(tconfig.get_arch(arch))
    rt = Runtime(param_dtype=torch.bfloat16)
    cpu = tmodel.init_params(cfg, 0, rt, "cpu")
    meta = tmodel.init_params(cfg, 0, rt, "meta")
    lc, lm = leaves_with_path(cpu), leaves_with_path(meta)
    assert [p for p, _ in lc] == [p for p, _ in lm]
    for (_, c), (_, m) in zip(lc, lm):
        assert m.device.type == "meta"
        assert (m.shape, m.dtype) == (c.shape, c.dtype)


def test_cpu_draws_unchanged():
    """The CPU weights are the generator's draws in init order, as before
    the meta route: the first draws, by the recipe."""
    cfg = tconfig.reduced_config(tconfig.get_arch("yi-9b"))
    rt = Runtime(param_dtype=torch.float32)
    p = tmodel.init_params(cfg, 7, rt, "cpu")
    gen = torch.Generator().manual_seed(7)
    D = cfg.d_model
    tok = torch.randn((cfg.vocab_size, D), generator=gen) / np.sqrt(D)
    untok = torch.randn((cfg.vocab_size, D), generator=gen) / np.sqrt(D)
    wq = torch.randn((D, cfg.num_heads * cfg.head_dim), generator=gen) \
        / np.sqrt(D)
    assert torch.equal(p["embed"]["tok"], tok)
    assert torch.equal(p["embed"]["untok"], untok)
    assert torch.equal(p["layers"][0]["wq"], wq)


# ---------------------------------------------------------------------------
# counting: meta against a real run on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def plain_as_kernels(monkeypatch):
    """On the CPU the kernels' plain versions run; book them as the
    kernels (``kernels.cost``), keep their own ops out of the count, and
    hand back their outputs in the kernels' layout (contiguous, as the
    wrappers allocate them), so the ops after them are the card's."""
    flash, scan = ref.flash_attention_ref, ref.rglru_scan_ref

    def flash_booked(q, k, v, *, causal=True, window=0, return_lse=False):
        cost.record_flash(q, k, causal, window, return_lse)
        with _disable_current_modes():
            out = flash(q, k, v, causal=causal, window=window,
                        return_lse=return_lse)
            if return_lse:
                return out[0].contiguous(), out[1].contiguous()
            return out.contiguous()

    def scan_booked(a, b, h0=None):
        cost.record_scan(a, h0)
        with _disable_current_modes():
            return scan(a, b, h0).contiguous()

    monkeypatch.setattr(ref, "flash_attention_ref", flash_booked)
    monkeypatch.setattr(ref, "rglru_scan_ref", scan_booked)


def _f32():
    return Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)


def _small_cells(arch):
    """Builders (device -> cell) of small cells of every program kind."""
    cfg = tconfig.reduced_config(tconfig.get_arch(arch))
    rt = _f32()
    train_rt = Runtime(param_dtype=torch.float32,
                       compute_dtype=torch.float32, remat=True,
                       vocab_chunk=8)
    pcfg = tpipe.PipelineConfig(n_stages=2, n_microbatches=2, mb_size=2)
    mesh = TDR.ONE_CARD
    cells = {
        "train": lambda d: TDR.train_cell(
            cfg, train_rt, topt.AdamWConfig(), 4, 16, mesh, accum=2,
            device=d),
        "prefill": lambda d: TDR.prefill_cell(cfg, rt, 2, 16, mesh,
                                              device=d),
        "decode": lambda d: TDR.decode_cell(cfg, rt, 2, 24, mesh, device=d),
    }
    try:
        tpipe.split_layers(cfg, 2)
        cells["pipe"] = lambda d: TDR.pipe_cell(
            cfg, rt, pcfg, 16, 24, mesh, prefill=True, decode_steps=1,
            rounds=2, device=d)
    except ValueError:
        pass
    return cells


def _count_warm(arch, cell, device):
    """``count`` with the RoPE tables' per-device caches
    (``models.common``) filled first: on the CPU their upload is no copy,
    on meta (and on the card) it is one."""
    cfg = tconfig.reduced_config(tconfig.get_arch(arch))
    dev = torch.device(device)
    for theta in (cfg.rope_theta, tmodel.LOCAL_ROPE_THETA):
        common._rope_freqs(cfg.head_dim, theta, dev)
    common._mrope_comp(cfg.head_dim, dev)
    return TDR.count(cell)


# xlstm's chunkwise mLSTM backward is long to run on the CPU; its serving
# programs cover the recurrent states
COUNT_CASES = [(arch, kind) for arch in ("yi-9b", "gemma3-1b",
                                         "recurrentgemma-9b",
                                         "qwen3-moe-235b-a22b", "xlstm-1.3b")
               for kind in ("train", "prefill", "decode", "pipe")
               if (arch, kind) != ("xlstm-1.3b", "train")]


@pytest.mark.parametrize("arch,kind", COUNT_CASES)
def test_meta_count_equals_the_cpu_count(arch, kind, plain_as_kernels):
    """Flops, bytes and kernel calls traced on meta equal those of the same
    program run on CPU tensors (the plain kernels booked by formula), for
    training (backward, remat, accumulation, AdamW), prefill, decode and
    the pipeline's passes."""
    build = _small_cells(arch).get(kind)
    if build is None:
        with pytest.raises(ValueError):
            tpipe.split_layers(tconfig.reduced_config(
                tconfig.get_arch(arch)), 2)
        return
    meta, cpu = (_count_warm(arch, build(d), d) for d in ("meta", "cpu"))
    assert (meta.flops, meta.bytes, meta.kernel_calls) == \
        (cpu.flops, cpu.bytes, cpu.kernel_calls)
    assert meta.flops > 0 and meta.bytes > 0


def test_affine_count_equals_a_full_trace(monkeypatch):
    """An attention-free prefill counted at three shorter lengths and
    extrapolated equals its full trace; a prefill with attention (its
    kernel's live pairs grow with the square of the length) is refused."""
    monkeypatch.setattr(TDR, "AFFINE_LENGTHS", (128, 192, 256))
    rt, mesh = _f32(), TDR.ONE_CARD
    cfg = tconfig.reduced_config(tconfig.get_arch("xlstm-1.3b"))
    build = lambda n: TDR.prefill_cell(cfg, rt, 2, n, mesh)
    got, full = TDR.affine_count(build, 384), TDR.count(build(384))
    assert (got.flops, got.bytes, got.temp_peak, got.kernel_calls) == \
        (full.flops, full.bytes, full.temp_peak, full.kernel_calls)
    assert TDR.affine_count(build, 100) is None      # off the lengths' grid
    yi = tconfig.reduced_config(tconfig.get_arch("yi-9b"))
    assert TDR.affine_count(
        lambda n: TDR.prefill_cell(yi, rt, 2, n, mesh), 384) is None


def test_census_flops_equal_flop_counter_mode():
    """The census applies ``FlopCounterMode``'s formulas itself; on a
    training step (forward and backward) the totals agree."""
    build = _small_cells("gemma3-1b")["train"]
    cell = build("meta")
    with FlopCounterMode(display=False) as fc:
        cell.fn(*cell.args)
    census = TDR.Census()
    with census:
        build("meta").fn(*build("meta").args)
    assert census.flops == fc.get_total_flops() > 0


def test_kernel_flops_come_from_the_formulas():
    """A prefill books one flash call a layer at the formula's flops."""
    cfg = tconfig.reduced_config(tconfig.get_arch("yi-9b"))
    cell = TDR.prefill_cell(cfg, _f32(), 2, 16, TDR.ONE_CARD)
    c = TDR.count(cell)
    assert c.kernel_calls == {"flash_attention": cfg.num_layers}
    with cost.counting() as k:
        cell.fn(*cell.args)
    one = cost.flash_cost(2, 16, 16, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim, True, 0, 4)
    assert (k.flops, k.bytes) == (cfg.num_layers * one[0],
                                  cfg.num_layers * one[1])


def test_peak_tracker_on_a_hand_made_sequence():
    census = TDR.Census()
    with census:
        a = torch.empty(1000, device="meta")          # 4,000 bytes
        b = a * 2                                     # 8,000 live
        del a                                         # 4,000
        v = b.view(10, 100)                           # no new storage
        c = b + 1                                     # 8,000
        del b                                         # v keeps it
        assert census.live == 8000
        del v                                         # 4,000
        assert census.live == 4000
        x = torch.empty(100, device="meta", requires_grad=True)  # 4,400
        y = x * 3                                     # 4,800, saved by sin
        z = y.sin().sum()                             # sin's out dies: 4,804
        del y                                         # the graph keeps it
        assert census.live == 4804
        del z                                         # graph gone: 4,400
        assert census.live == 4400
        del c, x
    assert census.peak == 8000 and census.live == 0
    # the arguments' storages are counted apart
    w = torch.empty(500, device="meta")
    census = TDR.Census(TDR._storages({"w": w}))
    with census:
        w.mul_(2)
        u = w + 1
    assert census.peak == 2000 and u.numel() == 500


def test_shape_cache_remakes_meta_outputs_only():
    """The census answers a repeated meta op from its shape cache; an op
    that made a tensor off meta (a factory op with a device) always runs."""
    census = TDR.Census()
    with census:
        a = torch.empty((4, 8), device="meta")
        first, again = a.sin(), a.sin()
        z1 = torch.zeros((3,), device="cpu")
        z2 = torch.zeros((3,), device="cpu")
        w = torch.full((2, 2), 7.0)
    assert again.device.type == "meta" and again.shape == first.shape
    assert again.untyped_storage()._cdata != first.untyped_storage()._cdata
    assert z1.device.type == z2.device.type == "cpu"
    assert torch.equal(z2, torch.zeros(3)) and w[0, 0] == 7.0


def test_bytes_of_views_inplace_and_allocations():
    census = TDR.Census()
    x = torch.empty(256, device="meta")               # 1,024 bytes
    with census:
        x.view(16, 16)                                # a view: nothing
        torch.empty(1000, device="meta")              # nothing written
        y = x + x                                     # 3 x 1,024
        y[:16].copy_(x[:16])                          # 16 floats: 2 x ... + 64
        y.mul_(2)                                     # read and write y
    assert census.bytes == 3 * 1024 + (64 + 2 * 64) + 2 * 1024


# ---------------------------------------------------------------------------
# records, the CLI, the kernel routes
# ---------------------------------------------------------------------------


def test_record_carries_h100_roofline_only(tmp_path):
    rec = TDR.run_cell("gemma3-1b", "decode_32k", "single_pod",
                       out_dir=str(tmp_path))
    assert rec["ok"] and rec["collectives"] is None
    r = rec["roofline"]
    assert set(r) == {"compute_s", "memory_s", "dominant", "bound_step_s",
                      "compute_fraction_of_bound"}
    assert r["compute_s"] == rec["flops_per_device"] / 989e12
    assert r["memory_s"] == rec["bytes_per_device"] / 3.35e12
    assert rec["n_devices"] == 256
    assert rec["flops_per_device"] == rec["flops"] / 256
    mem = rec["memory"]
    assert mem["peak_per_device"] == mem["argument_bytes"] + \
        mem["temp_bytes"]
    assert mem["fits_h100_80gb"] == (mem["peak_per_device"] <= 80e9)
    t = TDR.roofline_terms({"flops_per_device": 989e12,
                            "bytes_per_device": 3.35e12 / 2})
    assert (t["compute_s"], t["memory_s"], t["dominant"]) == \
        (1.0, 0.5, "compute_s")
    assert TDR.roofline_terms({"flops_per_device": 67e12,
                               "bytes_per_device": 0},
                              "float32")["compute_s"] == 1.0


def test_one_cli_cell_in_a_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma3-1b", "--shape", "prefill_32k", "--mesh", "multi", "--out",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(tmp_path / "gemma3-1b__prefill_32k__multi_pod.json") as f:
        rec = json.load(f)
    assert {"n_devices", "trace_s", "flops_per_device", "bytes_per_device",
            "memory", "collectives", "pod_boundary_bytes", "tokens_per_step",
            "kv_dtype", "roofline"} <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "temp_bytes",
                                  "peak_per_device", "fits_h100_80gb"}
    assert rec["ok"] and rec["n_devices"] == 512
    cfg = tconfig.get_arch("gemma3-1b")
    pcfg = TDR.serve_pipeline_config(tconfig.SHAPES["prefill_32k"])
    # every staged layer a microbatch, the epilogue's over the batch
    staged = tpipe.stage_ranges(cfg, 2)[-1][0]
    assert rec["kernel_calls"] == {"flash_attention": pcfg.n_microbatches
                                   * staged + cfg.num_layers - staged}
    # one (mb, S, D) bf16 handoff a microbatch between the two stages
    assert rec["pod_boundary_bytes"] == pcfg.n_microbatches * \
        pcfg.mb_size * 32768 * cfg.d_model * 2


def test_kernel_routes_send_no_cuda_tensor_to_the_meta_branch():
    assert ops.route(torch.device("cuda")) == "kernel"
    assert ops.route(torch.device("cuda", 1)) == "kernel"
    assert ops.route(torch.device("meta")) == "meta"
    assert ops.route(torch.device("cpu")) == "plain"
    # the meta route takes meta tensors only
    q = torch.empty((1, 8, 4, 64), device="meta")
    with pytest.raises(ValueError, match="meta route"):
        ops._flash_meta(q, torch.zeros(1, 8, 1, 64), q, True, 0, False)
    with pytest.raises(ValueError, match="meta route"):
        ops._scan(torch.empty((1, 8, 4), device="meta"),
                  torch.zeros(1, 8, 4))
    out, lse = ops._flash_meta(q, q[:, :, :1], q[:, :, :1], True, 0, True)
    assert out.shape == q.shape and lse.shape == (1, 1, 4, 8)
    assert lse.dtype == torch.float32
    # no fallback: the module has no try / except around a route
    src = open(ops.__file__).read()
    assert "try:" not in src and "except" not in src
    # the paged kernel has no meta route: it raises in the wrapper
    with pytest.raises(ValueError):
        ops.paged_decode_attention(
            torch.empty((1, 4, 64), device="meta"),
            torch.empty((2, 16, 1, 64), device="meta"),
            torch.empty((2, 16, 1, 64), device="meta"),
            torch.zeros((1, 1), dtype=torch.int32, device="meta"),
            torch.ones((1,), dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# kernels.cost against the formulas chip_smoke.py printed before
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _old_flash_bound(sq, skv, causal, window, h, hk, dh, esize, dtype_name,
                     b=1):
    """``chip_smoke.flash_bound`` as it was, with its loop over rows."""
    live = 0
    for i in range(sq):
        hi = min(i, skv - 1) if causal else skv - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        live += max(0, hi - lo + 1)
    flops = 4 * dh * h * live * b
    nbytes = (2 * sq * h * dh + 2 * skv * hk * dh) * esize * b
    t_ops = flops / {"bfloat16": 989e12, "float32": 67e12}[dtype_name]
    t_bytes = nbytes / 3.35e12
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops


def test_flash_bound_closed_form_equals_the_old_loop():
    cs = _chip_smoke()
    for sq in (1, 7, 8, 63, 64, 100, 129, 300):
        for skv in (1, 8, 64, 100, 300):
            for causal in (True, False):
                for window in (0, 1, 16, 64, 1024):
                    for name, esize in (("bfloat16", 2), ("float32", 4)):
                        args = (sq, skv, causal, window, 8, 2, 64, esize,
                                name)
                        assert cs.flash_bound(*args) == \
                            _old_flash_bound(*args)
                        assert cost.live_pairs(sq, skv, causal, window) == \
                            _old_flash_bound(*args)[2] // (4 * 64 * 8)
    # the shapes the card times
    for args in ((2048, 2048, True, 0, 16, 8, 256, 2, "bfloat16"),
                 (2048, 2048, True, 1024, 16, 8, 256, 2, "bfloat16"),
                 (4096, 4096, True, 2048, 16, 1, 256, 2, "bfloat16"),
                 (512, 512, True, 0, 32, 4, 128, 2, "bfloat16", 4)):
        assert cs.flash_bound(*args) == _old_flash_bound(*args)


def test_paged_and_scan_bounds_are_the_cost_formulas():
    cs = _chip_smoke()
    rng = np.random.default_rng(0)
    lens = rng.integers(0, 2048, 16).tolist()
    for window in (0, 1024):
        ms, by, nbytes = cs.bound(lens, window, 32, 4, 128, 2, "bfloat16",
                                  16, 128)
        flops, want = cost.paged_cost(lens, window, 32, 4, 128, 2, 16, 128)
        assert nbytes == want
        assert (ms, by) == cost.least_ms(flops, want, "bfloat16")
    toks = sum(min(n, 1024) for n in lens)
    assert cost.paged_cost(lens, 1024, 32, 4, 128, 2, 16, 128)[1] == \
        toks * 4 * 128 * 2 * 2 + 2 * 16 * 32 * 128 * 2 + 16 * 128 * 4 + 64
    assert cost.scan_cost(1, 4096, 4096) == (2 * 4096 * 4096,
                                             12 * 4096 * 4096)
    assert cost.scan_cost(2, 8, 4, h0=True)[1] == 12 * 64 + 4 * 8
    assert (cs.HBM_BYTES_PER_S, cs.PEAK_FLOPS) == (cost.HBM_BYTES_PER_S,
                                                   cost.PEAK_FLOPS)
