"""Where a decode step's time goes: one full-width decode step of the port,
timed on the host clock and traced with ``torch.profiler``.

  PYTHONPATH=src python -m repro_torch.launch.profile_decode

Builds yi-9b at full width and depth in bf16 (random weights from seed 0),
gives each of 16 rows 700 tokens of its own pages (the serve phase of
``chip_smoke.py``: its batch, page size and about its context), and runs
``models.model.decode_step`` directly (no engine).  Prints the step time
(host clock around synchronised steps, untraced and traced), the device
time inside a step by kernel (profiler), the device's busy share of the
untraced step (the traced step is slower: the profiler adds host work),
and the paged kernel's share.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import time

ARCH, BATCH, CTX, STEPS, PAGE, SEED = "yi-9b", 16, 700, 10, 16, 0


def main() -> None:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import get_arch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import Runtime, resolve_device
    from repro_torch.serving import kv_cache as kvc

    dev = resolve_device("cuda")
    cfg = get_arch(ARCH)
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    params = model_lib.init_params(cfg, SEED, rt, dev)
    B, page = BATCH, PAGE
    per_row = -(-(CTX + 3 * STEPS + 8) // page)
    pool = kvc.PoolConfig(page_size=page, n_local_pages=B * per_row + 1,
                          max_pages_per_seq=per_row)
    caches = kvc.build_paged_caches(cfg, B, pool, rt, dev)
    table = 1 + np.arange(B * per_row, dtype=np.int32).reshape(B, per_row)
    kvc.set_page_table(caches, table)
    tokens = torch.randint(1, cfg.vocab_size, (B,), device=dev)
    pos = [CTX]

    def step():
        cur = torch.full((B,), pos[0], dtype=torch.int32, device=dev)
        model_lib.decode_step(params, tokens, caches, cur, cfg, rt)
        pos[0] += 1

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / STEPS

    pa.paged_decode_attention.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t1) * 1e3 / STEPS
    rows = []                           # device kernels only (not the
    for ev in prof.key_averages():      # host ops that launched them)
        if ev.device_type == DeviceType.CUDA:
            rows.append((ev.self_device_time_total / 1e3 / STEPS,
                         ev.count // STEPS, ev.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    paged_ms = sum(r[0] for r in rows if "paged_decode" in r[2])
    print(f"{cfg.name} B={B} ctx={CTX} bf16: step {step_ms:.3f} ms "
          f"(host clock, untraced); traced step {traced_ms:.3f} ms; device "
          f"kernels {device_ms:.3f} ms a step = {device_ms / step_ms:.1%} of "
          f"the untraced step ({device_ms / traced_ms:.1%} of the traced "
          f"one); paged kernel {paged_ms:.3f} ms a step, "
          f"{pa.paged_decode_attention.launches // STEPS} launches")
    for ms, n, key in rows[:12]:
        print(f"  {ms:8.4f} ms  x{n:<5d} {key[:90]}")
    print(json.dumps({"step_ms": step_ms, "traced_step_ms": traced_ms,
                      "device_ms": device_ms, "paged_ms": paged_ms,
                      "device_busy": device_ms / step_ms,
                      "device_busy_traced": device_ms / traced_ms,
                      "weight_bytes_ms": cfg.param_count() * 2 / 3.35e9}))


if __name__ == "__main__":
    main()
