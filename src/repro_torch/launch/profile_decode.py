"""Where a serving step's time goes: full-width decode steps (and one
exact-length prefill) of the port, timed on the host clock and traced with
``torch.profiler``.

  PYTHONPATH=src python -m repro_torch.launch.profile_decode \
      [--arch yi-9b|gemma3-12b|recurrentgemma-9b ...]

One case an arch (all three without ``--arch``), each built at full width
and depth in bf16 (random weights from seed 0) and run through
``models.model`` directly (no engine):

* yi-9b decode: 16 rows of 700 tokens in their own pages (the yi-9b serve
  phase of ``chip_smoke.py``: its batch, page size and about its context);
* gemma3-12b decode: 16 rows of 1,300 tokens (about the gemma3 serve
  phase's mean context), global layers on pages, local layers on full
  rings of 1,024 slots; then one exact-length prefill of 1,328 tokens
  (about the serve phase's mean prompt) into a slot of those caches;
* recurrentgemma-9b decode: 16 rows of 1,700 tokens (about its serve
  phase's mean context), local layers on rings of 2,048 slots holding
  every position, recurrent states per row; then one exact-length prefill
  of a 1,664-token prompt (about the serve phase's mean) padded to its
  power-of-two bucket, 2,048, as the engine pads it.

For each it prints the step time (host clock around synchronised steps,
untraced and traced), the device time inside a step by kernel (profiler),
the device's busy share of the untraced step (the traced step is slower:
the profiler adds host work), and the hand-written kernels' shares.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

BATCH, STEPS, PAGE, SEED = 16, 10, 16, 0
# arch -> (decode context, prefill prompt length or 0)
CASES = {"yi-9b": (700, 0), "gemma3-12b": (1300, 1328),
         "recurrentgemma-9b": (1700, 1664)}


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


def report(label: str, cfg, step_ms, traced_ms, rows, launches) -> None:
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
    print(json.dumps({"case": label, "step_ms": step_ms,
                      "traced_step_ms": traced_ms, "device_ms": device_ms,
                      "paged_ms": paged_ms, "flash_ms": flash_ms,
                      "scan_ms": scan_ms,
                      "device_busy": device_ms / step_ms,
                      "device_busy_traced": device_ms / traced_ms,
                      "weight_bytes_ms": cfg.param_count() * 2 / 3.35e9}))


def build(torch, np, arch: str, ctx: int):
    """Weights and engine caches for 16 rows of ``ctx`` tokens: each row
    owns its pages, and every ring holds the window's last positions."""
    from repro_torch.config import get_arch
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import Runtime, resolve_device
    from repro_torch.serving import kv_cache as kvc

    dev = resolve_device("cuda")
    cfg = get_arch(arch)
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    params = model_lib.init_params(cfg, SEED, rt, dev)
    per_row = -(-(ctx + 3 * STEPS + 8) // PAGE)
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
    return cfg, rt, params, caches, dev


def run_case(torch, np, arch: str) -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.models import model as model_lib
    from repro_torch.serving import kv_cache as kvc

    ctx, n_prompt = CASES[arch]
    cfg, rt, params, caches, dev = build(torch, np, arch, ctx)
    tokens = torch.randint(1, cfg.vocab_size, (BATCH,), device=dev)
    pos = [ctx]

    def step():
        cur = torch.full((BATCH,), pos[0], dtype=torch.int32, device=dev)
        model_lib.decode_step(params, tokens, caches, cur, cfg, rt)
        pos[0] += 1

    pa.paged_decode_attention.launches = 0
    step_ms, traced_ms, rows = profile(torch, step, STEPS)
    report(f"{cfg.name} decode B={BATCH} ctx={ctx} bf16", cfg, step_ms,
           traced_ms, rows,
           {"paged": pa.paged_decode_attention.launches // (2 * STEPS + 3)})
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
        torch, lambda: model_lib.prefill(params, prompt, cfg, rt, 0,
                                         caches=view, last_index=last), 3)
    report(f"{cfg.name} exact prefill of {n_prompt} tokens padded to "
           f"S={S} bf16", cfg, step_ms, traced_ms, rows,
           {"flash": fa.flash_attention.launches // 9,
            "scan": rs.rglru_scan.launches // 9})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append", choices=sorted(CASES),
                    help="profile this arch (repeatable; default: all)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    for arch in args.arch or list(CASES):
        run_case(torch, np, arch)
        gc.collect()                    # this case's weights and caches
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
