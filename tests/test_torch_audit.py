"""The port's audit tooling (``repro_torch.analysis``) against
``repro.analysis``, float32 on the CPU.

- The runtime :class:`EngineAuditor`: the reference's cases (a page leak,
  an FSM back-step, offload parity / host-store / counter breaches, the
  ``REPRO_STRICT`` default), each corrupting a port engine and a JAX
  engine in the same way and raising at the same hook with the same
  message; transport books that a reshard resets; a kernel library
  loaded again mid-serve; and tracing plus auditing adding no host read
  of a tensor to a serve.
- The static lint: one inline fixture per rule, the suppression rules
  (the port's own marker, stacked under the JAX lint's), and the port's
  tree clean under its own lint with ``--strict-suppressions``.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread is as fast, and leaves the cores to
# the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import lint as jlint  # noqa: E402
from repro.config import get_arch as jax_get_arch  # noqa: E402
from repro.config import reduced_config as jax_reduced  # noqa: E402
from repro.core.offload import DoubleBufferOffloader as JaxOffloader  # noqa: E402,E501
from repro.models import model as jax_model  # noqa: E402
from repro.models.common import Runtime as JaxRuntime  # noqa: E402
from repro.serving.engine import OfflineEngine as JaxEngine  # noqa: E402
from repro.serving.kv_cache import PoolConfig as JaxPool  # noqa: E402
from repro.serving.request import Request as JaxRequest  # noqa: E402
from repro.serving.request import SamplingParams as JaxSP  # noqa: E402
from repro.serving.request import Status as JaxStatus  # noqa: E402
from repro_torch.analysis import invariants  # noqa: E402
from repro_torch.analysis.invariants import InvariantViolation  # noqa: E402
from repro_torch.analysis.lint import AuditConfig, run_lint  # noqa: E402
from repro_torch.config import get_arch, reduced_config  # noqa: E402
from repro_torch.core.offload import DoubleBufferOffloader  # noqa: E402
from repro_torch.distributed.transport import (  # noqa: E402
    SimulatedLinkTransport)
from repro_torch.kernels import build as kernel_build  # noqa: E402
from repro_torch.models.common import Runtime  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serving.engine import OfflineEngine  # noqa: E402
from repro_torch.serving.kv_cache import PoolConfig  # noqa: E402
from repro_torch.serving.request import Request, SamplingParams, Status  # noqa: E402,E501

REPO = Path(__file__).resolve().parents[1]
JRT = JaxRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32)
TRT = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
POOL = dict(page_size=8, n_local_pages=16, max_pages_per_seq=4)
OFF_POOL = dict(page_size=8, n_local_pages=16, n_global_pages=4,
                max_pages_per_seq=4)


@pytest.fixture(scope="module")
def model():
    jcfg = jax_reduced(jax_get_arch("yi-9b"))
    tcfg = reduced_config(get_arch("yi-9b"))
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0), JRT)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, TRT,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _engines(model, *, strict=True, mb=1, n_mb=1, max_new=4,
             offload=False):
    """A JAX engine and a port engine of the same shape, same weights."""
    jcfg, jparams, tcfg, tparams = model
    pool = OFF_POOL if offload else POOL
    jeng = JaxEngine(
        jcfg, jparams, JRT, mb_size=mb, num_microbatches=n_mb,
        pool=JaxPool(**pool),
        sampling=JaxSP(temperature=0.0, max_new_tokens=max_new),
        offloader=JaxOffloader(JaxPool(**pool), n_mb) if offload else None,
        strict=strict)
    teng = OfflineEngine(
        tcfg, tparams, TRT, mb_size=mb, num_microbatches=n_mb,
        pool=PoolConfig(**pool),
        sampling=SamplingParams(temperature=0.0, max_new_tokens=max_new),
        offloader=DoubleBufferOffloader(PoolConfig(**pool), n_mb)
        if offload else None, device="cpu", strict=strict)
    return jeng, teng


def _both_raise(jeng, teng, corrupt, hook, match):
    """Apply ``corrupt`` to each engine, call ``hook`` on it and return
    the two messages (each must be an ``InvariantViolation``)."""
    msgs = []
    for eng in (jeng, teng):
        corrupt(eng)
        with pytest.raises(AssertionError, match=match) as info:
            hook(eng)
        msgs.append(str(info.value))
    assert isinstance(info.value, InvariantViolation)
    return msgs


# --------------------------------------------------- runtime auditor ---


def test_strict_default_follows_env(monkeypatch, model):
    monkeypatch.setenv("REPRO_STRICT", "0")
    _, eng = _engines(model, strict=None)
    assert eng.auditor is None
    monkeypatch.setenv("REPRO_STRICT", "1")
    _, eng = _engines(model, strict=None)
    assert eng.auditor is not None
    # explicit flag beats the environment
    _, eng = _engines(model, strict=False)
    assert eng.auditor is None


def test_auditor_catches_page_leak_as_jax(model):
    jeng, teng = _engines(model)
    jeng.submit([JaxRequest(0, [3, 4, 5])])
    teng.submit([Request(0, [3, 4, 5])])
    jeng.step()
    teng.step()
    assert teng.auditor.checks == jeng.auditor.checks == 2

    def leak(eng):
        page = next(iter(eng.alloc._free_local))
        eng.alloc._free_local.remove(page)
    jmsg, tmsg = _both_raise(jeng, teng, leak, lambda e: e.step(),
                             r"\[step\] page audit")
    assert tmsg == jmsg
    assert "leaked" in tmsg


def test_auditor_catches_page_leak_at_submit_as_jax(model):
    jeng, teng = _engines(model)

    def double_grant(eng):
        eng.alloc._free_local.append(eng.alloc._free_local[0])
    jmsg, tmsg = _both_raise(
        jeng, teng, double_grant,
        lambda e: e.submit([(JaxRequest if e is jeng else Request)(
            0, [3, 4])]), r"\[submit\] page audit")
    assert tmsg == jmsg and "duplicate" in tmsg


def test_auditor_catches_fsm_backstep_as_jax(model):
    jeng, teng = _engines(model)
    jeng.submit([JaxRequest(0, [3, 4, 5])])
    teng.submit([Request(0, [3, 4, 5])])
    assert len(jeng.run(max_steps=100)) == len(teng.run(max_steps=100)) == 1

    def rewind(eng):
        eng.finished[0].status = (JaxStatus if eng is jeng
                                  else Status).DECODING
    jmsg, tmsg = _both_raise(jeng, teng, rewind,
                             lambda e: e.auditor.after_step(), r"fsm")
    assert tmsg == jmsg


def test_auditor_catches_offload_breaches_as_jax(model):
    jeng, teng = _engines(model, n_mb=2, offload=True)
    for eng in (jeng, teng):
        eng.auditor.after_step()           # consistent so far
    joff, toff = jeng.backend.offloader, teng.backend.offloader
    # (a) parity breach: pool 0 must only ever host even microbatches

    def parity(eng):
        eng.backend.offloader.resident[0] = 1
    jmsg, tmsg = _both_raise(jeng, teng, parity,
                             lambda e: e.auditor.after_step(), "parity")
    assert tmsg == jmsg
    joff.resident[0] = toff.resident[0] = None

    # (b) a stale host copy kept for a resident microbatch
    def stale(eng):
        eng.backend.offloader.resident[1] = 1
        eng.backend.offloader._host[1] = []
    jmsg, tmsg = _both_raise(jeng, teng, stale,
                             lambda e: e.auditor.after_step(), "host-store")
    assert tmsg == jmsg
    del joff._host[1], toff._host[1]

    # (c) counters must be monotone for the offloader's lifetime
    for off, eng in ((joff, jeng), (toff, teng)):
        off.swap_count = 5
        eng.auditor.after_step()

    def backward(eng):
        eng.backend.offloader.swap_count = 2
    jmsg, tmsg = _both_raise(jeng, teng, backward,
                             lambda e: e.auditor.after_step(), "backward")
    assert tmsg == jmsg


class _Amnesiac(SimulatedLinkTransport):
    """A transport whose ``for_stages`` forgets its books."""

    def for_stages(self, n_stages):
        return _Amnesiac(self.links[:1] * n_stages,
                         stage_time_s=self.stage_time_s).bind(n_stages)


def _pipelined(model, transport, **kw):
    *_, tcfg, tparams = model
    return OfflineEngine(
        tcfg, tparams, TRT, mb_size=1, num_microbatches=2,
        pool=PoolConfig(**OFF_POOL),
        sampling=SamplingParams(temperature=0.0, max_new_tokens=6),
        offloader=DoubleBufferOffloader(PoolConfig(**OFF_POOL), 2),
        backend="pipelined", n_stages=2, transport=transport,
        device="cpu", strict=True, **kw)


@pytest.mark.parametrize("carried", [True, False],
                         ids=["books-carried", "books-reset"])
def test_reshard_must_carry_the_transport_books(model, carried):
    cls = SimulatedLinkTransport if carried else _Amnesiac
    eng = _pipelined(model, cls.uniform(2, 0.01))
    eng.submit([Request(i, [3 + i, 4, 5]) for i in range(2)])
    for _ in range(6):
        eng.step()
    books = eng.backend.transport_stats()
    assert books["wire_bytes"] > 0
    if carried:
        eng.reshard(n_stages=1)         # the drain ships more, never less
        assert eng.backend.transport_stats()["wire_bytes"] >= \
            books["wire_bytes"]
        eng.run(max_steps=200)
        assert len(eng.finished) == 2
        return
    with pytest.raises(InvariantViolation,
                       match=r"\[reshard\] transport: .* went backward .*"
                             r"dropped the books across reshard"):
        eng.reshard(n_stages=1)


class _Lib:
    """Stands in for a loaded ``ctypes`` kernel library."""

    def __init__(self, name, handle):
        self._name, self._handle = name, handle


def test_kernel_library_loaded_again_mid_serve(model, monkeypatch):
    assert invariants.library_identity(object()) is None
    libs = {"paged_attention": _Lib("build/kernels/libpaged_a.so", 0x1000)}
    monkeypatch.setattr(kernel_build, "_LOADED", libs)
    _, eng = _engines(model)
    eng.submit([Request(0, [3, 4, 5])])
    eng.step()
    assert eng.backend.kernel_libraries() == libs
    libs["flash_attention"] = _Lib("build/kernels/libflash_b.so", 0x2000)
    eng.step()                          # a first load is no violation
    libs["paged_attention"] = _Lib("build/kernels/libpaged_c.so", 0x3000)
    with pytest.raises(InvariantViolation,
                       match=r"\[step\] kernels: library 'paged_attention' "
                             "was built or loaded again mid-serve"):
        eng.step()


# host reads of a tensor's values: each is a device sync on the card
_HOST_READS = ("item", "cpu", "numpy", "tolist", "__bool__", "__int__",
               "__float__", "__index__")


def _count_host_reads(monkeypatch):
    counts = {"n": 0}
    for name in _HOST_READS:
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, **kw):
            counts["n"] += 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    return counts


@pytest.mark.parametrize("backend", ["local", "pipelined"])
def test_trace_and_strict_add_no_host_read(model, monkeypatch, backend):
    """The same serve with the recorder and the auditor on and off reads
    the same number of tensor values on the host (each read is a device
    sync on the card), and the hooks themselves read none."""
    *_, tcfg, tparams = model
    reqs = [([3 + i, 4, 5, 6, 7][:2 + i], 0.0 if i % 2 else 0.9)
            for i in range(4)]

    def serve(on):
        kw = dict(trace=True, strict=True) if on else dict(strict=False)
        if backend == "pipelined":
            kw.update(backend="pipelined", n_stages=2,
                      transport=SimulatedLinkTransport.uniform(2, 0.01))
        eng = OfflineEngine(
            tcfg, tparams, TRT, mb_size=2, num_microbatches=2,
            pool=PoolConfig(**OFF_POOL),
            offloader=DoubleBufferOffloader(PoolConfig(**OFF_POOL), 2),
            device="cpu", **kw)
        counts = _count_host_reads(monkeypatch)
        seqs = eng.submit([Request(i, p, SamplingParams(
            temperature=t, max_new_tokens=5)) for i, (p, t) in
            enumerate(reqs)])
        eng.run(max_steps=300)
        monkeypatch.undo()
        return eng, [s.generated for s in seqs], counts["n"]

    off_eng, off_streams, off_reads = serve(False)
    on_eng, on_streams, on_reads = serve(True)
    assert on_streams == off_streams
    assert on_reads == off_reads > 0
    assert on_eng.auditor.checks > 0 and len(on_eng.recorder.events) > 0
    # and none inside the hooks, called on their own
    counts = _count_host_reads(monkeypatch)
    on_eng.auditor.after_step()
    on_eng.auditor.after_submit()
    for rid in range(len(reqs)):
        on_eng.request_trace(rid)
    assert counts["n"] == 0


# ------------------------------------------------------------- lint ---


def _lint(tmp_path, name, source, **cfg):
    f = tmp_path / f"{name}.py"
    f.write_text(textwrap.dedent(source))
    base = dict(hot_roots=[f"{name}:hot_step"], offload_windows=[])
    base.update(cfg)
    return f, run_lint([f], config=AuditConfig(**base))


def _expect(f):
    """``[(rule, line)]`` from ``# EXPECT: <rule>`` markers."""
    out = []
    for i, line in enumerate(f.read_text().splitlines(), start=1):
        if "# EXPECT:" in line:
            out.append((line.split("# EXPECT:")[1].strip(), i))
    return sorted(out)


HOST_SYNC = """\
import numpy as np
import torch


def helper(x):
    return x.item()                          # EXPECT: host-sync


def hot_step(model, tokens, sizes):
    logits = model.decode_step(tokens)
    probs = torch.softmax(logits, -1)
    n = probs.shape[0] + probs.numel()       # static: no sync
    if logits is None or len(probs) == 0:    # static: no sync
        return None
    if probs.max() > 0.5:                    # EXPECT: host-sync
        pass
    best = int(probs.argmax())               # EXPECT: host-sync
    rows = probs.tolist()                    # EXPECT: host-sync
    host = np.asarray(logits)                # EXPECT: host-sync
    moved = logits.cpu()                     # EXPECT: host-sync
    torch.cuda.synchronize()                 # EXPECT: host-sync
    torch.cuda.current_stream().synchronize()  # EXPECT: host-sync
    widths = [int(s) for s in sizes]         # host values: no sync
    return helper(probs), best, rows, host, moved, n, widths


def cold(x):
    return x.item()                          # not reachable: no report
"""


def test_host_sync_fixture(tmp_path):
    f, vs = _lint(tmp_path, "fx_sync", HOST_SYNC)
    assert sorted((v.rule, v.line) for v in vs) == _expect(f)
    assert all(v.path == str(f) for v in vs)


OFFLOAD = """\
import numpy as np
import torch


class Offloader:
    def ensure_resident(self, caches, mb):
        self._stream.synchronize()                  # EXPECT: offload-sync
        self.block_until_ready()                    # EXPECT: offload-sync
        snap = np.asarray(caches[0])                # EXPECT: offload-sync
        torch.cuda.synchronize()                    # EXPECT: offload-sync
        caches[0].copy_(caches[1], non_blocking=True)   # enqueued: fine
        return snap

    def outside(self):
        self._stream.synchronize()                  # not in the window
"""


def test_offload_sync_fixture(tmp_path):
    f, vs = _lint(tmp_path, "fx_off", OFFLOAD, hot_roots=[],
                  offload_windows=["fx_off:Offloader.ensure_resident"])
    assert sorted((v.rule, v.line) for v in vs) == _expect(f)
    assert "copy stream" in vs[0].msg        # says what to do instead


OBS = """\
import time


def hot_step(engine, tokens):
    logits = engine.model.decode_step(tokens)
    t0 = time.perf_counter()
    engine.recorder.step_phase("decode", t0, time.perf_counter(), 3)
    engine.recorder.request_tokens(0, logits, t0)      # EXPECT: obs-hot-path
    rec = engine.recorder
    rec.fault("drop", t0, (("lp", logits.max()),))     # EXPECT: obs-hot-path
    rec.fault("drop", t0, (("rows", logits.shape[0]),))    # static: fine
    return logits


def cold(engine, logits):
    engine.recorder.request_tokens(0, logits, 0.0)     # not reachable
"""


def test_obs_hot_path_fixture(tmp_path):
    f, vs = _lint(tmp_path, "fx_obs", OBS)
    assert sorted((v.rule, v.line) for v in vs) == _expect(f)
    assert all("host scalars" in v.msg for v in vs)


RETRACE = """\
import torch

from repro_torch.kernels import build

_lib = None


def hot_step(model, x):
    fn = torch.compile(model)                   # EXPECT: retrace-jit
    g = torch.cuda.CUDAGraph()                  # EXPECT: retrace-jit
    return fn(x), g, _library()


def _library():
    global _lib
    if _lib is None:
        _lib = build.load("paged_attention")    # EXPECT: retrace-jit
    return _lib


def setup(model):
    return torch.compile(model)                 # not in the hot path
"""


def test_retrace_jit_fixture(tmp_path):
    f, vs = _lint(tmp_path, "fx_jit", RETRACE)
    assert sorted((v.rule, v.line) for v in vs) == _expect(f)


PRNG = """\
import torch

from repro_torch.serving.sampler import request_seed, token_seed


def draws(gen, seed, rid, t, keys):
    gen.manual_seed(1234)                                   # EXPECT: prng-fold-drop
    gen.manual_seed(request_seed(seed, rid))                # EXPECT: prng-fold-drop
    gen.manual_seed(token_seed(7, t))                       # EXPECT: prng-fold-drop
    base = request_seed(seed, rid)
    gen.manual_seed(base)                                   # EXPECT: prng-fold-drop
    gen.manual_seed(token_seed(base, t))                    # the discipline
    gen.manual_seed(token_seed(request_seed(seed, rid), t))  # the discipline
    gen.manual_seed(token_seed(int(keys[0]), t))            # unknown chain
    gen.manual_seed(seed)                                   # unknown chain
    return torch.rand((4,), generator=gen)
"""


def test_prng_fold_drop_fixture(tmp_path):
    f, vs = _lint(tmp_path, "fx_prng", PRNG, hot_roots=[])
    assert sorted((v.rule, v.line) for v in vs) == _expect(f)
    msgs = [v.msg for v in sorted(vs, key=lambda v: v.line)]
    assert "request_id AND token_idx" in msgs[0]
    assert "token_idx dropped" in msgs[1]
    assert "request_id dropped" in msgs[2]


def test_suppression_rules(tmp_path):
    src = textwrap.dedent("""\
        import torch


        def hot_step(x):
            # repro-torch-audit: allow(host-sync) — the tick's one copy
            # repro-audit: allow(host-sync) — the JAX lint's own marker
            a = x.cpu()
            b = x.cpu()  # repro-torch-audit: allow(host-sync) — trailing
            # repro-audit: allow(host-sync) — only the JAX lint's marker
            c = x.item()
            '''# repro-torch-audit: allow(host-sync) — quoted, not real'''
            d = x.item()
            return a, b, c, d
        """)
    f = tmp_path / "mod_sup.py"
    f.write_text(src)
    cfg = AuditConfig(hot_roots=["mod_sup:hot_step"])
    vs = run_lint([f], config=cfg, strict_suppressions=True)
    # the JAX marker and a docstring mention silence nothing here
    assert [(v.rule, v.line) for v in vs] == [("host-sync", 10),
                                              ("host-sync", 12)]


def test_strict_suppressions_flag_unreasoned_stale_and_unknown(tmp_path):
    f = tmp_path / "mod_stale.py"
    f.write_text(
        "def helper():\n"
        "    # repro-torch-audit: allow(host-sync)\n"      # no reason
        "    return 1\n\n\n"
        "def other():\n"
        "    # repro-torch-audit: allow(retrace-branch) — not a port rule\n"
        "    return 2\n\n\n"
        "def third():\n"
        "    # repro-torch-audit: allow(obs-hot-path) — stale after a fix\n"
        "    return 3\n")
    cfg = AuditConfig(hot_roots=[])
    assert run_lint([f], config=cfg) == []          # default: tolerated
    vs = run_lint([f], config=cfg, strict_suppressions=True)
    assert sorted(v.rule for v in vs) == \
        ["bad-suppression", "bad-suppression", "unused-suppression"]


def test_port_marker_is_invisible_to_the_jax_lint(tmp_path):
    """Both lints scan the port: a port-only suppression must be neither
    an unknown rule nor a stale marker under the JAX lint."""
    f = tmp_path / "mod_both.py"
    f.write_text(textwrap.dedent("""\
        def hot_step(x):
            # repro-torch-audit: allow(host-sync) — the port's copy
            return x.cpu()
        """))
    cfg = jlint.AuditConfig(hot_roots=["mod_both:hot_step"], traced_fns=[])
    assert jlint.run_lint([f], config=cfg, strict_suppressions=True) == []
    assert run_lint([f], config=AuditConfig(hot_roots=["mod_both:hot_step"]),
                    strict_suppressions=True) == []


def test_port_tree_is_clean_under_its_own_lint():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch",
         "--strict-suppressions"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr[-2000:]}"
    assert "repro-torch-audit: clean" in r.stdout
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--list-rules"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
    assert r.stdout.split() == ["host-sync", "offload-sync", "obs-hot-path",
                                "retrace-jit", "prng-fold-drop",
                                "bad-suppression", "unused-suppression"]
