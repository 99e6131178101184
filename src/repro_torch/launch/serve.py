"""Offline serving entry point of the PyTorch port: the ``LLM`` front end over
the local or the pipelined backend (counterpart of ``repro.launch.serve``;
its fault, reshard, online, tracing and audit options come with later
slices).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \\
      --requests 16 --max-new 24 [--mixed] [--full] [--device cpu|cuda] \\
      [--prefill-mode auto|chunked|exact] [--backend local|pipelined]

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

``--backend pipelined`` serves through DeServe's §4.3 circular pipeline of
``--stages`` stages (one process, the stages in turn on one device), with
``--schedule circular|round_flush`` (the vLLM-PP baseline drains the pipe
every token round), ``--transport-compress int8`` (the per-row int8 wire
on every stage boundary; ``topk`` is wire-byte accounting only), and
simulated links on a virtual clock: ``--link-latency`` seconds on every
link, or ``--deployment`` regions (one stage a region, latencies from the
registry's region table).  The run then prints the transport's books and
the decode tok/s on the virtual clock:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --backend pipelined --stages 2 --microbatches 3 --link-latency 0.064

``--plan`` derives (N_B, per-microbatch batch, pool split) through the
§4.3 planner (``EngineConfig.plan``) from a measured stage time,
``--latency`` (or the deployment's slowest link), ``--stages`` and
``--kv-budget-mb``.  On the card it also measures the pinned
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
                    help="pipeline stages (pipelined backend / --plan)")
    ap.add_argument("--backend", default="local",
                    choices=["local", "pipelined"])
    ap.add_argument("--link-latency", type=float, default=None,
                    help="uniform simulated one-way latency (seconds) on "
                         "every inter-stage link, accounted on a virtual "
                         "clock (pipelined backend); an explicit 0 is a "
                         "zero-cost simulated link, not 'unset'")
    ap.add_argument("--deployment", default="",
                    metavar="REGION[,REGION...]",
                    help="one pipeline stage per region (e.g. "
                         "us-west,us-west,us-east): per-link latencies "
                         "from the registry's region table; overrides "
                         "--stages and, under --plan, --latency")
    ap.add_argument("--schedule", default="circular",
                    choices=["circular", "round_flush"],
                    help="circular = DeServe §4.3 (default); round_flush "
                         "= the vLLM-PP baseline (pipe drained every "
                         "token round)")
    ap.add_argument("--transport-compress", default="none",
                    choices=["none", "int8", "topk"],
                    help="int8: the per-row int8 wire on every stage "
                         "boundary (wire_dtype='int8'; the books equal "
                         "the packed payload); topk: wire-byte accounting "
                         "only (simulated links)")
    args = ap.parse_args(argv)

    deployment = None
    if args.deployment:
        if args.backend != "pipelined":
            raise SystemExit("--deployment requires --backend pipelined")
        from repro_torch.distributed.transport import DeploymentPlan
        deployment = DeploymentPlan.from_regions(
            [r.strip() for r in args.deployment.split(",") if r.strip()])
        args.stages = deployment.n_stages
    if args.backend != "pipelined" and (
            args.link_latency is not None or args.schedule != "circular"
            or args.transport_compress != "none"):
        raise SystemExit("--link-latency / --schedule / "
                         "--transport-compress require --backend pipelined")
    if args.transport_compress == "topk" and deployment is None \
            and args.link_latency is None:
        raise SystemExit("--transport-compress topk is accounting only — "
                         "it needs a simulated link (--link-latency or "
                         "--deployment) to account on")

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

    # int8 is the real wire codec: EngineConfig(wire_dtype=) drives the
    # ticks and the backend's transport wrap, so the books equal the packed
    # payload.  top-k stays an accounting wrapper built here.
    wire_dtype = "int8" if args.transport_compress == "int8" else "fp32"
    compress = "topk" if args.transport_compress == "topk" else None
    transport = None
    if deployment is not None:
        transport = deployment.transport(compress=compress)
        print(deployment.describe())
    elif args.link_latency is not None:
        from repro_torch.distributed.transport import (
            CompressedTransport, SimulatedLinkTransport)
        transport = SimulatedLinkTransport.uniform(args.stages,
                                                   args.link_latency)
        if compress:
            transport = CompressedTransport(transport, method=compress)
        print(f"links: uniform {args.link_latency * 1000:.0f}ms one-way "
              f"x{args.stages} (virtual clock)"
              + (", topk wire accounting (accounting only)"
                 if compress else ""))
    if wire_dtype == "int8":
        print("wire codec: int8 per row on every stage boundary (one "
              "float32 scale a row)")
    pipe = dict(backend=args.backend, transport=transport,
                schedule=args.schedule, wire_dtype=wire_dtype)
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
        # planner latency: the deployment's slowest ring link beats a
        # uniform --link-latency (an explicit 0 is a zero-cost link) beats
        # the bare --latency guess
        plan_latency = None if deployment is not None else (
            args.link_latency if args.link_latency is not None
            else args.latency)
        eff_latency = deployment.max_link_latency if deployment is not None \
            else plan_latency
        print(f"planned: measured stage_time={t_s * 1000:.1f}ms "
              f"latency={eff_latency * 1000:.0f}ms"
              f"{' (deployment max link)' if deployment else ''} "
              f"stages={args.stages} kv_budget={args.kv_budget_mb:.1f}MB; "
              f"swap bandwidth {bw_note}")
        econfig = EngineConfig.plan(
            n_stages=args.stages, stage_time=t_s, latency=plan_latency,
            deployment=deployment, **pipe,
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
            prefill_mode=args.prefill_mode, n_stages=args.stages, **pipe)
    llm = LLM(cfg, config=econfig, params=params, rt=rt, device=device)
    engine = llm.engine
    print(f"arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
          f"params={cfg.param_count() / 1e6:.1f}M dtype={rt.param_dtype} "
          f"device={engine.device} backend={engine.backend.name}")
    if engine.backend.name == "pipelined":
        be = engine.backend
        print(f"pipeline: {be.n_stages} stages of layers "
              f"{be.ranges[:-1]}, epilogue {be.ranges[-1]}; "
              f"{args.schedule} schedule, {wire_dtype} wire, "
              f"{be.transport.name} transport")
    if args.plan:
        print(f"schedule: {engine.schedule_choice}; mb_size="
              f"{engine.mb_size} x N_B={engine.num_microbatches}; pool "
              f"{engine.pool}")
    off = getattr(engine.backend, "offloader", None)
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
    if "transport" in rep:
        t = rep["transport"]
        line = (f"transport: {t.get('transport')} "
                f"virtual_time={t.get('virtual_time_s', 0.0):.2f}s "
                f"virtual decode tok/s="
                f"{rep.get('virtual_decode_tok_per_s', 0.0):.1f} "
                f"wire={t.get('wire_bytes', 0)}B "
                f"link_stall={t.get('link_stall_s', 0.0):.2f}s")
        if "compression_ratio" in t:
            line += (f" (raw {t['raw_bytes']}B, "
                     f"{t['compression_ratio']:.1f}x on the wire)")
        print(line)
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
