"""Where a serving step's time goes: full-width decode steps, exact-length
prefills and a prefill chunk of the port, eager and replayed from a
captured CUDA graph, timed on the host clock and on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      [--arch yi-9b|gemma3-12b|recurrentgemma-9b|xlstm-1.3b|
              phi3.5-moe-42b-a6.6b ...] [--pass fixed|train ...]

One case an arch (all five without ``--arch``), each built at full width
in bf16 (random weights from seed 0) and run through ``models.model``
directly (no engine):

* yi-9b decode: 16 rows of 700 tokens in their own pages (the yi-9b serve
  phase of ``chip_smoke.py``: its batch, page size and about its context);
  then one prefill chunk of 8 rows x 32 tokens (that phase's chunk) at
  offsets up to 640 in those rows' pages;
* gemma3-12b decode: 16 rows of 1,300 tokens (about the gemma3 serve
  phase's mean context), global layers on pages, local layers on full
  rings of 1,024 slots; then one exact-length prefill of 1,328 tokens
  (about the serve phase's mean prompt) into a slot of those caches;
* recurrentgemma-9b decode: 16 rows of 1,700 tokens (about its serve
  phase's mean context), local layers on rings of 2,048 slots holding
  every position, recurrent states per row; then one exact-length prefill
  of a 1,664-token prompt (about the serve phase's mean) padded to its
  power-of-two bucket, 2,048, as the engine pads it;
* xlstm-1.3b decode: 16 rows at 512 tokens (``chip_smoke.py``'s tick
  context; its recurrent states hold no positions), full depth;
* phi3.5-moe decode: 16 rows of 512 tokens at 24 of its 32 layers (the
  full model's 83.7 GB of weights do not fit one card; ``chip_smoke.py``
  serves the same depth).

Two more cases (``--pass``; both run when neither flag is given):

* ``fixed``: full yi-9b through ``core.pipeline.FixedPasses`` at
  ``chip_smoke.py``'s ``[fixed-pipe]`` geometry (2 stages of 24 layers, 4
  microbatches of 4 rows, 512-token prompts): one decode stage call (4
  rows, 24 layers) and one greedy round's drain (the head and the pick
  over 4 rows), each eager and replayed from its graph, at position 512;
* ``train``: full gemma3-1b training steps in float32 at batch 4 x 1024
  (``chip_smoke.py``'s ``[train-gemma3-1b]``): the training loop's step
  (``training.train_loop``'s static step, the update in place) eager, and
  replayed from the graph ``train`` captures at its second step.

For each decode it prints the eager step (host clock around synchronised
steps, untraced and traced; the device time inside a step by kernel, from
the profiler) and the same step captured once as a CUDA graph
(``serving.step_graph``) and replayed (host clock; the profiler's kernel
rows, which it sees one by one inside a replay, and CUDA events around a
replay issued behind a spin of the card), with each one's device busy
share: the counterpart of the engine's replayed decode tick.  Each
prefill is timed the same two ways: eager (``models.model.prefill`` over
a one-row view, or the chunk's ``_chunk_fn`` after its inputs' copies)
and replayed through a ``serving.backend.LocalBackend`` over the same
caches (``prefill`` / ``prefill_step``: the inputs packed into the static
input, the replay, the logits copied out, the card synchronised), with
the capture's and the instantiation's seconds.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time

BATCH, STEPS, PAGE, SEED = 16, 10, 16, 0
# arch -> (decode context, prefill prompt length or 0, layers or 0 = all)
CASES = {"yi-9b": (700, 0, 0), "gemma3-12b": (1300, 1328, 0),
         "recurrentgemma-9b": (1700, 1664, 0), "xlstm-1.3b": (512, 0, 0),
         "phi3.5-moe-42b-a6.6b": (512, 0, 24)}
# arch -> (rows, tokens) of a profiled prefill chunk
CHUNKS = {"yi-9b": (8, 32)}
# torch.cuda._sleep cycles a ms at the H100's top SM clock (1.98 GHz)
SPIN_CYCLES_PER_MS = 1_980_000
# --pass fixed: (stages, microbatches, rows, prompt, capacity), yi-9b
FIXED = (2, 4, 4, 512, 576)
# --pass train: gemma3-1b, (batch, sequence), float32; steps a timing
TRAIN, TRAIN_STEPS = (4, 1024), 3
PASSES = ("fixed", "train")


def profile(torch, fn, steps: int):
    """(untraced ms, traced ms, [(device ms, launches, kernel)]) per call
    of ``fn``, after 3 warm-up calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t1) * 1e3 / steps
    rows = []                           # device kernels only (not the
    for ev in prof.key_averages():      # host ops that launched them)
        if ev.device_type == DeviceType.CUDA:
            rows.append((ev.self_device_time_total / 1e3 / steps,
                         ev.count // steps, ev.key))
    rows.sort(reverse=True)
    return step_ms, traced_ms, rows


def device_span(torch, fn, steps: int, host_ms: float) -> float:
    """Median ms between CUDA events around one call of ``fn`` issued
    while the card spins for twice ``host_ms``: the card's work alone for
    a replay (one graph launch).  Not for an eager step: its couple of
    thousand launches fill the launch queue behind the spin, and the host
    then issues the rest while the card runs, gaps and all."""
    spans = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2 * host_ms * SPIN_CYCLES_PER_MS))
        start.record()
        fn()
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    return sorted(spans)[len(spans) // 2]


def report(label: str, cfg, step_ms, traced_ms, rows, launches,
           **extra) -> None:
    device_ms = sum(r[0] for r in rows)
    paged_ms = sum(r[0] for r in rows if "paged_split" in r[2])
    flash_ms = sum(r[0] for r in rows if "flash_fwd" in r[2])
    scan_ms = sum(r[0] for r in rows if "rglru_scan" in r[2])
    print(f"{label}: step {step_ms:.3f} ms (host clock, untraced); traced "
          f"step {traced_ms:.3f} ms; device kernels {device_ms:.3f} ms a "
          f"step = {device_ms / step_ms:.1%} of the untraced step "
          f"({device_ms / traced_ms:.1%} of the traced one); paged kernel "
          f"{paged_ms:.3f} ms, flash kernel {flash_ms:.3f} ms, scan kernel "
          f"{scan_ms:.3f} ms a step; launches a step {launches}")
    for ms, n, key in rows[:12]:
        print(f"  {ms:8.4f} ms  x{n:<5d} {key[:90]}")
    if "replay_step_ms" in extra:
        print(f"{label}, replayed from its CUDA graph: step "
              f"{extra['replay_step_ms']:.3f} ms (host clock), device "
              f"kernels {extra['replay_device_ms']:.3f} ms a step = "
              f"{extra['replay_device_busy']:.1%} busy (CUDA events around "
              f"a replay: {extra['replay_span_ms']:.3f} ms); kernels "
              f"{extra['replay_kernel_rows']} rows in the profiler's trace")
        for ms, n, key in extra["replay_rows"][:6]:
            print(f"  {ms:8.4f} ms  x{n:<5d} {key[:90]}")
        extra = {k: v for k, v in extra.items() if k != "replay_rows"}
    print(json.dumps({"case": label, "step_ms": step_ms,
                      "traced_step_ms": traced_ms, "device_ms": device_ms,
                      "paged_ms": paged_ms, "flash_ms": flash_ms,
                      "scan_ms": scan_ms,
                      "device_busy": device_ms / step_ms,
                      "device_busy_traced": device_ms / traced_ms,
                      "weight_bytes_ms": cfg.param_count() * 2 / 3.35e9,
                      **extra}))


def build(torch, np, arch: str, ctx: int, layers: int = 0):
    """Weights and engine caches for 16 rows of ``ctx`` tokens: each row
    owns its pages, and every ring holds the window's last positions;
    ``layers`` cuts the depth (0: every layer)."""
    from repro_torch.config import get_arch
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import Runtime, resolve_device
    from repro_torch.serving import kv_cache as kvc

    dev = resolve_device("cuda")
    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    params = model_lib.init_params(cfg, SEED, rt, dev)
    per_row = -(-(ctx + 4 * STEPS + 8) // PAGE)
    pool = kvc.PoolConfig(page_size=PAGE,
                          n_local_pages=BATCH * per_row + 1,
                          max_pages_per_seq=per_row)
    caches = kvc.build_paged_caches(cfg, BATCH, pool, rt, dev)
    table = 1 + np.arange(BATCH * per_row, dtype=np.int32).reshape(BATCH,
                                                                   per_row)
    kvc.set_page_table(caches, table)
    for layer in caches["layers"]:
        if "pos" in layer:
            c = layer["pos"].shape[1]
            p = torch.arange(max(ctx - c, 0), ctx, device=dev)
            layer["pos"][:, p % c] = p.to(torch.int32)
    return cfg, rt, params, caches, dev, pool


def replayed(torch, cfg, rt, params, caches, dev, pool, tokens, pos):
    """``decode_step`` over the whole batch captured once as a CUDA graph
    (``serving.step_graph.StepGraphs``) and replayed: the step's
    positions in a static tensor, set before each replay, its logits
    copied into a static output.  Returns a function of one step."""
    from repro_torch.models import model as model_lib
    from repro_torch.serving.backend import reserve_paged_workspace
    from repro_torch.serving.step_graph import StepGraphs

    graphs = StepGraphs(prepare=lambda device: reserve_paged_workspace(
        cfg, pool, BATCH, device))
    cur = torch.zeros((BATCH,), dtype=torch.int32, device=dev)
    logits = torch.zeros((BATCH, cfg.vocab_size), dtype=torch.float32,
                         device=dev)

    def body():
        out, _ = model_lib.decode_step(params, tokens, caches, cur, cfg, rt)
        logits.copy_(out)

    def step():
        cur.fill_(pos[0])
        graphs.run("decode", dev, body)
        pos[0] += 1
    return step


def run_case(torch, np, arch: str) -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.models import model as model_lib
    from repro_torch.serving import kv_cache as kvc

    ctx, n_prompt, layers = CASES[arch]
    cfg, rt, params, caches, dev, pool = build(torch, np, arch, ctx, layers)
    tokens = torch.randint(1, cfg.vocab_size, (BATCH,), dtype=torch.int32,
                           device=dev)
    pos = [ctx]

    @torch.inference_mode()
    def step():
        cur = torch.full((BATCH,), pos[0], dtype=torch.int32, device=dev)
        model_lib.decode_step(params, tokens, caches, cur, cfg, rt)
        pos[0] += 1

    pa.paged_decode_attention.launches = 0
    step_ms, traced_ms, rows = profile(torch, step, STEPS)
    launches = {"paged": pa.paged_decode_attention.launches //
                (2 * STEPS + 3)}
    # the same step, replayed: positions restart at the context (the
    # writes land where the eager steps' did)
    pos[0] = ctx
    replay = torch.inference_mode()(
        replayed(torch, cfg, rt, params, caches, dev, pool, tokens, pos))
    replay_ms, _, replay_rows = profile(torch, replay, STEPS)
    replay_dev = sum(r[0] for r in replay_rows)
    span = device_span(torch, replay, STEPS, replay_ms)
    report(f"{cfg.name} decode B={BATCH} ctx={ctx} bf16"
           + (f", {layers} of {get_layers(arch)} layers" if layers
              else ""), cfg, step_ms, traced_ms, rows, launches,
           replay_step_ms=replay_ms, replay_device_ms=replay_dev,
           replay_device_busy=replay_dev / replay_ms, replay_span_ms=span,
           replay_kernel_rows=len(replay_rows), replay_rows=replay_rows)
    from repro_torch.serving.backend import LocalBackend
    be = LocalBackend(cfg, params, rt, mb_size=BATCH, num_microbatches=1,
                      pool=pool, device=dev, caches=caches)
    if arch in CHUNKS:
        prefill_chunk_case(torch, np, cfg, rt, params, caches, be, dev,
                           *CHUNKS[arch])
    if not n_prompt:
        return
    # the engine's bucket: the next power of two with recurrent layers,
    # else a multiple of 8
    S = max(8, 1 << (n_prompt - 1).bit_length()) if \
        cfg.recurrent_layer_count() else max(8, -(-n_prompt // 8) * 8)
    prompt = torch.randint(1, cfg.vocab_size, (1, S), device=dev)
    view = kvc.slot_view(caches, 0, 1)
    last = torch.full((1,), n_prompt - 1, dtype=torch.int32, device=dev)
    fa.flash_attention.launches = 0
    rs.rglru_scan.launches = 0
    step_ms, traced_ms, rows = profile(
        torch, lambda: model_lib.prefill(params, {"tokens": prompt}, cfg, rt,
                                         0, caches=view, last_index=last), 3)
    label = f"{cfg.name} exact prefill of {n_prompt} tokens padded to S={S}"
    launches = {"flash": fa.flash_attention.launches // 9,
                "scan": rs.rglru_scan.launches // 9}
    # the same prefill through the backend's captured step: its first call
    # runs eagerly, its second captures (profile's warm-up calls)
    toks = prompt[0].cpu().numpy().astype(np.int32)
    replay = torch.inference_mode()(
        lambda: be.prefill(toks, 0, n_prompt - 1))
    report(label + " bf16", cfg, step_ms, traced_ms, rows, launches,
           **replay_extra(torch, be, replay, 3))


def replay_extra(torch, be, replay, steps: int) -> dict:
    """``report``'s replay fields for a backend's captured prefill call
    ``replay`` (each call synchronises the card), and the capture's and
    the instantiation's seconds."""
    replay_ms, _, replay_rows = profile(torch, replay, steps)
    replay_dev = sum(r[0] for r in replay_rows)
    st = be.graphs.stats()
    return dict(replay_step_ms=replay_ms, replay_device_ms=replay_dev,
                replay_device_busy=replay_dev / replay_ms,
                replay_span_ms=device_span(torch, replay, steps, replay_ms),
                replay_kernel_rows=len(replay_rows), replay_rows=replay_rows,
                capture_s=st["capture_s"], instantiate_s=st["instantiate_s"],
                captures=st["captures"], eager_first_calls=st["eager_by_kind"])


def prefill_chunk_case(torch, np, cfg, rt, params, caches, be, dev,
                       rows: int, clen: int) -> None:
    """One prefill chunk of ``rows`` x ``clen`` tokens over the first rows'
    pages, eager (the inputs copied to the card, then ``_chunk_fn``) and
    replayed (``LocalBackend.prefill_step``, captured at its first
    call)."""
    from repro_torch.serving.backend import LocalBackend, PrefillChunk

    rng = np.random.RandomState(SEED)
    table = caches["page_table"][:rows].cpu().numpy()
    n_valid = np.full((rows,), clen, np.int32)
    n_valid[rows // 2:] = clen // 2             # half the rows end here
    chunk = PrefillChunk(
        tokens=rng.randint(1, cfg.vocab_size, (rows, clen)).astype(np.int32),
        offsets=(rng.randint(0, 21, rows) * clen).astype(np.int32),
        n_valid=n_valid,
        lasts=np.where(n_valid < clen, n_valid - 1, -1).astype(np.int32),
        tables=table.astype(np.int32), seqs=[None] * rows)

    @torch.inference_mode()
    def eager():
        inputs = [torch.from_numpy(a).to(dev) for a in (
            chunk.tokens, chunk.offsets, chunk.n_valid, chunk.lasts,
            chunk.tables)]
        LocalBackend._chunk_fn(params, caches, *inputs, cfg=cfg, rt=rt)

    step_ms, traced_ms, prof_rows = profile(torch, eager, STEPS)
    replay = torch.inference_mode()(lambda: be.prefill_step(chunk))
    report(f"{cfg.name} prefill chunk {rows} x {clen} tokens bf16", cfg,
           step_ms, traced_ms, prof_rows, {},
           **replay_extra(torch, be, replay, STEPS))


def fixed_case(torch, np) -> None:
    """``--pass fixed``: a yi-9b decode stage call and a rounds drain of
    ``FixedPasses``, eager (the step's body) and replayed."""
    from repro_torch.config import get_arch
    from repro_torch.core import pipeline as PL
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import Runtime, resolve_device

    dev = resolve_device("cuda")
    cfg = get_arch("yi-9b")
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    params = model_lib.init_params(cfg, SEED, rt, dev)
    n_s, n_mb, mb, S, cap = FIXED
    fp = PL.FixedPasses(params, cfg, rt, PL.PipelineConfig(n_s, n_mb, mb),
                        cap, device=dev)
    prompts = torch.randint(1, cfg.vocab_size, (n_mb, mb, S),
                            dtype=torch.int32, device=dev)
    tok = fp.prefill(prompts).argmax(-1).to(torch.int32)
    cur = torch.full((n_mb, mb), S, dtype=torch.int32, device=dev)
    fp.decode_rounds(tok, cur, rounds=1)    # captures the stages, drains
    # each call starts from position S (a drain advances it)
    pos = fp._pos[fp.devices[-1]]
    calls = {"stage": (lambda: fp._stage(0, 0, "decode"),
                       lambda: fp.stage_call(0, 0)),
             "drain": (lambda: fp._drain(0), lambda: fp.drain_call(0))}
    for name, (eager, replay) in calls.items():
        def at(fn):
            def call():
                pos.fill_(S)
                fn()
            return call
        step_ms, traced_ms, rows = profile(torch, at(eager), STEPS)
        replay_ms, _, replay_rows = profile(torch, at(replay), STEPS)
        replay_dev = sum(r[0] for r in replay_rows)
        label = (f"yi-9b fixed-pass decode stage call ({mb} rows, "
                 f"{cfg.num_layers // n_s} layers)" if name == "stage" else
                 f"yi-9b fixed-pass rounds drain ({mb} rows: head and "
                 "greedy pick)")
        report(label + " bf16", cfg, step_ms, traced_ms, rows, {},
               replay_step_ms=replay_ms, replay_device_ms=replay_dev,
               replay_device_busy=replay_dev / replay_ms,
               replay_span_ms=device_span(torch, at(replay), STEPS,
                                          replay_ms),
               replay_kernel_rows=len(replay_rows), replay_rows=replay_rows)


def train_case(torch, np) -> None:
    """``--pass train``: a gemma3-1b float32 training step at batch 4 x
    1024, the loop's static step called eagerly and replayed."""
    from functools import partial

    from repro_torch.config import get_arch
    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import Runtime, resolve_device
    from repro_torch.serving.step_graph import StepGraphs
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_loop

    dev = resolve_device("cuda")
    cfg = get_arch("gemma3-1b")
    rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
    ocfg = opt_lib.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    params = model_lib.init_params(cfg, SEED, rt, dev)
    opt = opt_lib.init(ocfg, params)
    B, S = TRAIN
    batch = {k: torch.as_tensor(v).to(dev) for k, v in next(batches(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B,
                   seed=SEED))).items()}
    metrics = {n: torch.zeros((), dtype=torch.float32, device=dev)
               for n in ("loss", "lr", "grad_norm")}
    step = partial(train_loop._static_step, params, opt, batch, metrics,
                   cfg=cfg, rt=rt, ocfg=ocfg, accum_steps=1,
                   compressor=None)
    graphs = StepGraphs(release_cache=True)
    step_ms, traced_ms, rows = profile(torch, step, TRAIN_STEPS)
    # profile's warm-up calls: the eager first run, the capture, a replay
    replay = partial(graphs.run, ("train",), dev, step, defer=True)
    replay_ms, _, replay_rows = profile(torch, replay, TRAIN_STEPS)
    replay_dev = sum(r[0] for r in replay_rows)
    st = graphs.stats()
    report(f"gemma3-1b training step B={B} S={S} float32", cfg, step_ms,
           traced_ms, rows, {},
           replay_step_ms=replay_ms, replay_device_ms=replay_dev,
           replay_device_busy=replay_dev / replay_ms,
           replay_span_ms=device_span(torch, replay, TRAIN_STEPS,
                                      replay_ms),
           replay_kernel_rows=len(replay_rows), replay_rows=replay_rows,
           capture_s=st["capture_s"], instantiate_s=st["instantiate_s"],
           peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
           peak_reserved_gib=torch.cuda.max_memory_reserved() / 2 ** 30)
    graphs.clear()


def get_layers(arch: str) -> int:
    from repro_torch.config import get_arch
    return get_arch(arch).num_layers


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append", choices=sorted(CASES),
                    help="profile this arch (repeatable; default: all)")
    ap.add_argument("--pass", dest="passes", action="append",
                    choices=PASSES, help="profile a fixed-pass stage call "
                    "and drain, or a training step (repeatable; default: "
                    "both, when --arch is not given either)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    everything = not args.arch and not args.passes
    cases = [(run_case, arch) for arch in
             (list(CASES) if everything else args.arch or [])]
    cases += [({"fixed": fixed_case, "train": train_case}[p],) for p in
              (PASSES if everything else args.passes or [])]
    for fn, *arg in cases:
        fn(torch, np, *arg)
        gc.collect()                    # this case's weights and caches
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
