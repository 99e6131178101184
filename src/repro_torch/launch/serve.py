"""Offline serving entry point of the PyTorch port: the ``LLM`` front end over
the local backend (counterpart of ``repro.launch.serve``, local path).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \\
      --requests 16 --max-new 24 [--mixed] [--full] [--device cpu|cuda] \\
      [--prefill-mode auto|chunked|exact]

``--arch`` takes every registered arch of the port (``yi-9b``,
``gemma3-12b``, ``gemma3-1b``, ``recurrentgemma-9b``); the sliding-window
layers of gemma3 and recurrentgemma and recurrentgemma's RG-LRU layers are
served through exact-length prefill, which ``--prefill-mode auto`` picks.
For example, full-width recurrentgemma on the card:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-9b --full --device cuda

Runs on ``cuda`` by default and raises when there is none; ``--device cpu``
runs the plain PyTorch path.  ``--full`` serves the registered width and
depth in bf16 (random weights from ``--seed``); without it the arch is
shrunk with ``reduced_config`` and runs in float32.

``--plan`` derives (N_B, per-microbatch batch, pool split) through the
§4.3 planner (``EngineConfig.plan``) from a measured stage time,
``--latency``, ``--stages`` (a planning input only: the backend stays
local) and ``--kv-budget-mb``.  On the card it also measures the pinned
host copy rate and sizes the global pools, double-buffered to host memory
(§4.2), with it; on the CPU the paper's PCIe rate stands in.  The run
ends with the §3 break-even lines of the cost model.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --plan \
      --latency 0.064 --stages 2 --kv-budget-mb 4
"""

from __future__ import annotations

import argparse
import time


def measure_stage_time(cfg, params, rt, n_stages: int, device) -> float:
    """Wall-time one single-sequence decode step (after a warm-up step,
    with a card synchronisation on each side) and attribute 1/n_stages of
    it to each stage: the measurement the §4.3 planner consumes."""
    import torch

    from repro_torch.models import model as model_lib

    dev = torch.device(device)
    caches = model_lib.init_caches(cfg, 1, 64, rt, dev)
    tok = torch.zeros((1,), dtype=torch.int32, device=dev)
    cur = torch.ones((1,), dtype=torch.int32, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    model_lib.decode_step(params, tok, caches, cur, cfg, rt)      # warm
    sync()
    t0 = time.perf_counter()
    model_lib.decode_step(params, tok, caches, cur, cfg, rt)
    sync()
    return max(1e-4, (time.perf_counter() - t0) / n_stages)


def pinned_copy_rate(device, nbytes: int = 256 << 20, iters: int = 5):
    """The card's ``(host-to-device, device-to-host)`` rate in bytes/s
    between pinned host memory and the card: ``nbytes`` a copy, the mean
    of ``iters`` copies after one warm-up, timed with CUDA events."""
    import torch

    dev = torch.device(device)
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    rates = []
    for dst, src in ((card, host), (host, card)):
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        rates.append(nbytes * iters / (start.elapsed_time(end) * 1e-3))
    return rates[0], rates[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--mb-size", type=int, default=2)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--max-pages", type=int, default=16,
                    help="KV pages per sequence")
    ap.add_argument("--prefill-chunk", type=int, default=0)
    ap.add_argument("--max-prefill-tokens", type=int, default=0)
    ap.add_argument("--prefill-mode", default="auto",
                    choices=["auto", "chunked", "exact"],
                    help="chunked admission (fully-paged archs) vs the "
                         "exact-length fallback; auto picks per arch")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--mixed", action="store_true",
                    help="serve greedy and sampled requests side by side")
    ap.add_argument("--full", action="store_true",
                    help="the registered width and depth, bf16")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan", action="store_true",
                    help="derive N_B, batch and pools from the measured "
                         "stage time + --latency (EngineConfig.plan)")
    ap.add_argument("--kv-budget-mb", type=float, default=4.0,
                    help="per-stage KV byte budget for --plan")
    ap.add_argument("--latency", type=float, default=0.064,
                    help="one-way link latency (s) the planner assumes")
    ap.add_argument("--stages", type=int, default=2,
                    help="pipeline stages the planner assumes")
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    from repro_torch.config import get_arch, reduced_config
    from repro_torch.core.cost_model import (PLATFORMS, min_throughput,
                                             profit_per_hour)
    from repro_torch.core.scheduler import optimal_microbatches
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import Runtime, resolve_device
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import LLM, EngineConfig
    from repro_torch.serving.request import SamplingParams

    cfg = get_arch(args.arch)
    if args.full:
        rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    else:
        cfg = reduced_config(cfg)
        rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
    device = resolve_device(args.device)
    params = model_lib.init_params(cfg, args.seed, rt, device)
    if args.plan:
        t_s = measure_stage_time(cfg, params, rt, args.stages, device)
        if device.type == "cuda":
            h2d, d2h = pinned_copy_rate(device)
            bandwidth = min(h2d, d2h)
            bw_note = (f"measured pinned H2D {h2d / 1e9:.2f} / D2H "
                       f"{d2h / 1e9:.2f} GB/s on "
                       f"{torch.cuda.get_device_name(device)}")
        else:
            bandwidth = 0.0
            bw_note = "the paper's PCIe 4.0 rate (no card to measure)"
        print(f"planned: measured stage_time={t_s * 1000:.1f}ms "
              f"latency={args.latency * 1000:.0f}ms stages={args.stages} "
              f"kv_budget={args.kv_budget_mb:.1f}MB; swap bandwidth "
              f"{bw_note}")
        econfig = EngineConfig.plan(
            n_stages=args.stages, stage_time=t_s, latency=args.latency,
            m_kv_bytes=args.kv_budget_mb * 1e6, bandwidth=bandwidth,
            page_size=args.page_size, max_pages_per_seq=args.max_pages,
            max_microbatches=16, mb_size_cap=4, seed=args.seed,
            prefill_chunk=args.prefill_chunk,
            max_prefill_tokens_per_tick=args.max_prefill_tokens,
            prefill_mode=args.prefill_mode)
    else:
        batch = args.mb_size * args.microbatches
        pool = PoolConfig(page_size=args.page_size,
                          n_local_pages=batch * args.max_pages + 1,
                          max_pages_per_seq=args.max_pages)
        econfig = EngineConfig(
            mb_size=args.mb_size, num_microbatches=args.microbatches,
            pool=pool, seed=args.seed, prefill_chunk=args.prefill_chunk,
            max_prefill_tokens_per_tick=args.max_prefill_tokens,
            prefill_mode=args.prefill_mode)
    llm = LLM(cfg, config=econfig, params=params, rt=rt, device=device)
    engine = llm.engine
    print(f"arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
          f"params={cfg.param_count() / 1e6:.1f}M dtype={rt.param_dtype} "
          f"device={engine.device}")
    if args.plan:
        print(f"schedule: {engine.schedule_choice}; mb_size="
              f"{engine.mb_size} x N_B={engine.num_microbatches}; pool "
              f"{engine.pool}")
    off = engine.backend.offloader
    if off is not None:
        print(f"offload: 2 global pools of {engine.pool.n_global_pages} "
              f"pages, double-buffered to host memory "
              f"({'copy stream' if off.async_swap else 'blocking'})")
    if engine.chunked_prefill:
        print(f"prefill: chunked (chunk={engine.prefill_chunk} tokens, "
              f"budget={engine.max_prefill_tokens_per_tick} tokens/tick, "
              f"rows={engine.prefill_rows})")
    else:
        pad = "the next power of two" if cfg.recurrent_layer_count() else \
            "a multiple of 8"
        print(f"prefill: exact-length (one whole prompt per free slot, "
              f"padded to {pad})")

    rng = np.random.RandomState(args.seed)
    prompts = [list(rng.randint(1, cfg.vocab_size, rng.randint(4, 24)))
               for _ in range(args.requests)]
    if args.mixed:
        policies = [SamplingParams(temperature=0.0),
                    SamplingParams(temperature=0.8),
                    SamplingParams(temperature=1.0, top_k=20),
                    SamplingParams(temperature=0.9, top_p=0.92)]
        sps = [dataclasses.replace(policies[i % len(policies)],
                                   max_new_tokens=args.max_new)
               for i in range(args.requests)]
    else:
        sps = SamplingParams(temperature=args.temperature,
                             max_new_tokens=args.max_new)
    outs = llm.generate(prompts, sps)
    rep = llm.stats()
    done = [o for o in outs if o.finished]
    print(f"finished {len(done)}/{args.requests} requests in "
          f"{rep['wall_time_s']:.2f}s ({rep['decode_tok_per_s']:.1f} decode "
          f"tok/s, {rep['prefill_tok_per_s']:.1f} prefill tok/s on "
          f"{engine.device}; mean latency {rep['mean_latency_steps']:.1f} "
          f"steps / {rep['mean_latency_s']:.2f}s)")
    reasons: dict = {}
    for o in outs:
        reasons[o.finish_reason] = reasons.get(o.finish_reason, 0) + 1
    print(f"finish reasons: {reasons}")
    print(f"report: {rep}")

    n_b = optimal_microbatches(8, 0.08, args.latency)
    print(f"\nschedule report (8-stage pipeline, T_S=80ms, "
          f"L={args.latency * 1000:.0f}ms): N_B* = {n_b}")
    for name in ("mining", "ionet", "cloud"):
        p = PLATFORMS[name]
        print(f"  {name:8s} break-even {min_throughput(p.cost_per_hour):8.1f}"
              f" tok/s; at 450 tok/s profit/h = "
              f"${profit_per_hour(450, p.cost_per_hour):+.2f}")


if __name__ == "__main__":
    main()
