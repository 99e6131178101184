"""Serving entry point of the PyTorch port: the ``LLM`` front end over the
local or the pipelined backend (counterpart of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \\
      --requests 16 --max-new 24 [--mixed] [--full] [--device cpu|cuda] \\
      [--prefill-mode auto|chunked|exact] [--backend local|pipelined]

``--arch`` takes every registered arch of the port (``yi-9b``,
``gemma3-12b``, ``gemma3-1b``, ``recurrentgemma-9b``,
``phi3.5-moe-42b-a6.6b``, ``qwen3-moe-235b-a22b``, ``xlstm-1.3b``,
``llama3-70b``, ``minitron-4b``); the sliding-window layers of gemma3 and
recurrentgemma and the recurrent layers of recurrentgemma and xlstm are
served through exact-length prefill, which ``--prefill-mode auto`` picks.
For example, full-width recurrentgemma on the card:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-9b --full --device cuda

Runs on ``cuda`` by default and raises when there is none; ``--device cpu``
runs the plain PyTorch path.  ``--full`` serves the registered width and
depth in bf16 (random weights from ``--seed``); without it the arch is
shrunk with ``reduced_config`` and runs in float32.

``--backend pipelined`` serves through DeServe's §4.3 circular pipeline of
``--stages`` stages (one process issuing the stages in turn, each on its
own device: ``--mesh cuda:0,cuda:1`` puts stage ``s`` and its weights,
caches and offloader on the ``s``-th device, the first being ``--device``'s;
without it every stage is on ``--device``), with
``--schedule circular|round_flush`` (the vLLM-PP baseline drains the pipe
every token round), ``--transport-compress int8`` (the per-row int8 wire
on every stage boundary; ``topk`` is wire-byte accounting only), and
simulated links on a virtual clock: ``--link-latency`` seconds on every
link, or ``--deployment`` regions (one stage a region, latencies from the
registry's region table).  The run then prints the transport's books and
the decode tok/s on the virtual clock:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --backend pipelined --stages 2 --microbatches 3 --link-latency 0.064

Full-depth phi3.5-moe (83.7 GB of bf16 weights) over two cards:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch phi3.5-moe-42b-a6.6b --full --backend pipelined --stages 2 \
      --mesh cuda:0,cuda:1

``--plan`` derives (N_B, per-microbatch batch, pool split) through the
§4.3 planner (``EngineConfig.plan``) from a measured stage time,
``--latency`` (or the deployment's slowest link), ``--stages`` and
``--kv-budget-mb``.  On the card it also measures the pinned
host copy rate and sizes the global pools, double-buffered to host memory
(§4.2), with it; on the CPU the paper's PCIe rate stands in.  The run
ends with the §3 break-even lines of the cost model.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --plan \
      --latency 0.064 --stages 2 --kv-budget-mb 4

Resilience drills (pipelined backend): ``--inject-fault
kind@plane:tick:stage[:delay_s]`` (repeatable) drops or delays a stage
tick; the engine injects the lost work again and the streams do not
change.  ``--reshard-at STEP:STAGES`` rebuilds the pipe with STAGES stages
after engine step STEP, carrying every request's progress.
``--detect-failures TIMEOUT`` drives ``OfflineEngine.reshard`` from a
:class:`~repro_torch.distributed.elastic.FailureDetector` instead: one
heartbeat a stage a step, ``--kill-device STEP:DEVICE`` silences a device,
and the loop reshards when the detector declares it dead
(``--heartbeat-clock steps`` counts TIMEOUT in steps, the default in
wall seconds).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --backend pipelined --inject-fault drop@decode:5:1 --reshard-at 20:1

Online serving: ``--online`` submits seeded Poisson arrivals
(``--arrival-rate`` requests a second) into the running engine through
:class:`~repro_torch.serving.online.OnlineLLM` and reports the p50 / p99
time to first token and inter-token latency; ``--prefix-cache`` shares
prompt blocks between requests (``--system-prompt N`` gives every request
the same N-token head); ``--slo-ttft`` / ``--slo-itl`` turn on the SLO
admission policy.  The streams are the offline path's in every mode.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --online --prefix-cache --system-prompt 32

Observability and audit: ``--trace OUT.json`` turns on the flight
recorder (``EngineConfig(trace=True)``) and writes a Perfetto-loadable
Chrome-trace timeline at exit — engine step phases, per-microbatch stage
occupancy, per-link transfers on the virtual clock, offload swaps,
prefix-cache, SLO, fault and reshard events, and where the host's time
goes inside a step: a ``backend`` track of each decode call's
``decode.inputs`` / ``decode.noise`` / ``decode.launch`` /
``decode.readout`` and each prefill call's ``prefill.inputs`` /
``prefill.launch`` / ``prefill.wait``, and an ``engine/host`` track of the
engine's own booking (``build_chunk``, ``apply_prefill``,
``apply_decode``); check it with ``python -m repro_torch.obs.timeline
--check OUT.json``.  In Python, ``OfflineEngine.set_recorder(rec)``
attaches a recorder to a running engine and ``set_recorder(None)``
detaches it (a few seconds of a live serve), and
``write_chrome_trace(rec, path, base_ns=...)``, given a ``torch.profiler``
trace's ``baseTimeNanoseconds``, lays the wall events on that trace's
time base through the recorder's clock anchor, so the two files'
``traceEvents`` concatenate into one Perfetto view of host phases beside
kernels.  ``--strict`` turns on the
runtime invariant auditor (``EngineConfig(strict=True)``), which checks
the engine's books after every submit, step and reshard.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --trace out.json --strict

``--metrics`` keeps a metrics registry (``obs.metrics``) over the run:
a one-line ``[metrics]`` banner every ``--metrics-every`` engine steps and
the Prometheus exposition text at exit, as the JAX serve CLI prints them.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --metrics --metrics-every 2
"""

from __future__ import annotations

import argparse
import time


def measure_stage_time(cfg, params, rt, n_stages: int, device,
                       mesh=None) -> float:
    """The slowest stage's single-sequence decode time
    (:func:`stage_times`): the measurement the §4.3 planner consumes (the
    pipe ticks at its slowest stage).  When the planner asks about more
    stages than the model's layer plan can form (a reduced model, no
    mesh), the whole model is timed as one stage and each of the
    ``n_stages`` is given an even share."""
    from repro_torch.models.common import make_layer_plan
    if mesh is None and make_layer_plan(
            cfg.num_layers, cfg.block_pattern).n_periods < n_stages:
        return max(1e-4, stage_times(cfg, params, rt, 1, device)[0]
                   / n_stages)
    return max(1e-4, max(stage_times(cfg, params, rt, n_stages, device,
                                     mesh)))


def stage_times(cfg, params, rt, n_stages: int, device, mesh=None) -> list:
    """Wall-time one single-sequence decode step of each stage on its own
    device (``mesh``, one device a stage, or every stage on ``device``;
    ``params`` placed over it), with a synchronisation of the stage's card
    on each side: seconds a stage.  On a card the step is captured as a
    CUDA graph at its first run and the replay is timed, as the engine
    runs its stages (``serving.step_graph``); on the CPU the second of
    two eager steps is.  The embedding is made once outside; the epilogue
    and the head are timed with the last stage."""
    import torch

    from repro_torch.core import pipeline as PL
    from repro_torch.models import embedding as embed_lib
    from repro_torch.models import model as model_lib
    from repro_torch.serving.backend import stage_devices
    from repro_torch.serving.step_graph import StepGraphs

    devs = stage_devices(mesh, n_stages, device)
    ranges = PL.stage_ranges(cfg, n_stages)
    head = model_lib.tied_head(params, cfg, devs[-1])
    caches = model_lib.init_caches(cfg, 1, 64, rt, devs[0])
    for i, dev in enumerate(PL.layer_devices(cfg, devs)):
        caches["layers"][i] = {k: t.to(dev)
                               for k, t in caches["layers"][i].items()}
    x0 = embed_lib.embed_tokens(
        params["embed"], torch.zeros((1, 1), dtype=torch.int32,
                                     device=devs[0]), cfg, rt.compute_dtype)

    def sync(dev):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # the steps leave nothing behind (no output outlives a replay), so
    # their graphs may share one pool
    graphs = StepGraphs()

    def stage(s: int, dev) -> float:
        x = x0.to(dev)
        cur = torch.ones((1, 1), dtype=torch.int32, device=dev)
        layers = [ranges[s]] + ([ranges[-1]] if s == n_stages - 1 else [])

        def step():
            y = x
            for lo, hi in layers:
                if hi > lo:
                    y = model_lib.run_layers(params, y, cfg, rt,
                                             mode="decode", caches=caches,
                                             positions=cur, layers=(lo, hi))
            if s == n_stages - 1:
                model_lib.decode_logits(params, y, cfg, head)

        for _ in range(2):                      # warm (capture), then timed
            sync(dev)
            t0 = time.perf_counter()
            graphs.run(("stage", s), dev, step)
            sync(dev)
            dt = time.perf_counter() - t0
        return dt

    return [stage(s, d) for s, d in enumerate(devs)]


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


def build_parser() -> argparse.ArgumentParser:
    """The serve CLI's flags."""
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
    ap.add_argument("--full", "--full-size", dest="full",
                    action="store_true",
                    help="the registered width and depth, bf16 "
                         "(--full-size is the JAX serve CLI's name)")
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
    ap.add_argument("--mesh", default="", metavar="DEVICE[,DEVICE...]",
                    help="one device a pipeline stage (e.g. cuda:0,cuda:1; "
                         "pipelined backend): each stage's weights, caches "
                         "and offloader on its device, the first being "
                         "--device's (default: the first entry)")
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
    ap.add_argument("--inject-fault", action="append", default=[],
                    metavar="kind@plane:tick:stage[:delay_s]",
                    help="drop/delay a pipeline stage tick (repeatable; "
                         "pipelined backend), e.g. drop@decode:12:1 or "
                         "delay@prefill:3:0:0.25 — lost work is "
                         "injected again, the streams do not change")
    ap.add_argument("--reshard-at", default="", metavar="STEP:STAGES",
                    help="rebuild the pipelined backend with STAGES stages "
                         "after engine step STEP (no token recomputed)")
    ap.add_argument("--detect-failures", type=float, default=0.0,
                    metavar="TIMEOUT",
                    help="drive OfflineEngine.reshard from a "
                         "FailureDetector: one heartbeat a stage a step, "
                         "reshard when a device misses TIMEOUT (pipelined "
                         "backend)")
    ap.add_argument("--kill-device", action="append", default=[],
                    metavar="STEP:DEVICE",
                    help="stop heartbeating DEVICE after engine step STEP "
                         "(repeatable; the --detect-failures signal)")
    ap.add_argument("--heartbeat-clock", default="monotonic",
                    choices=["monotonic", "steps"],
                    help="clock of the --detect-failures heartbeats: wall "
                         "seconds (TIMEOUT in seconds) or the engine step "
                         "index (TIMEOUT in steps; deterministic drills)")
    ap.add_argument("--online", action="store_true",
                    help="Poisson arrivals submitted into the live engine "
                         "(OnlineLLM), tokens streamed per tick; reports "
                         "p50/p99 TTFT and inter-token latency")
    ap.add_argument("--arrival-rate", type=float, default=8.0,
                    help="mean Poisson arrival rate for --online, requests "
                         "a second (seeded)")
    ap.add_argument("--system-prompt", type=int, default=0,
                    metavar="TOKENS",
                    help="prepend a shared TOKENS-long system prompt to "
                         "every request (the prefix-cache workload)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share fully prefilled prompt blocks between "
                         "requests (refcounted pages; chunked prefill)")
    ap.add_argument("--slo-ttft", type=float, default=0.0,
                    help="TTFT target (s) of the SLO admission policy "
                         "(0 = off)")
    ap.add_argument("--slo-itl", type=float, default=0.0,
                    help="inter-token (per-tick) target (s) of the SLO "
                         "admission policy (0 = off)")
    ap.add_argument("--trace", default="", metavar="OUT.json",
                    help="flight recorder: record engine/transport/request "
                         "spans and write a Chrome-trace (Perfetto) "
                         "timeline to OUT.json at exit")
    ap.add_argument("--strict", action="store_true",
                    help="enable the runtime invariant auditor "
                         "(repro_torch.analysis.invariants): page / FSM / "
                         "transport / offload / kernel-library audits "
                         "after every step, failing at the tick that "
                         "corrupted state")
    ap.add_argument("--metrics", action="store_true",
                    help="metrics registry over the run: a one-line stats "
                         "banner every --metrics-every engine steps plus "
                         "Prometheus exposition text at exit")
    ap.add_argument("--metrics-every", type=int, default=50,
                    metavar="STEPS",
                    help="engine steps between --metrics banners")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

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
    detect = args.detect_failures > 0
    if detect and args.backend != "pipelined":
        raise SystemExit("--detect-failures requires --backend pipelined")
    kills = {}
    for spec in args.kill_device:
        try:
            step_s, dev_s = spec.split(":")
            kills[int(dev_s)] = int(step_s)
        except ValueError:
            raise SystemExit(f"--kill-device wants STEP:DEVICE, got {spec!r}")
    if kills and not detect:
        raise SystemExit("--kill-device only matters under "
                         "--detect-failures (nobody is listening for "
                         "missed heartbeats)")
    reshard_at, reshard_stages = 0, 0
    if args.reshard_at:
        try:
            step_s, stages_s = args.reshard_at.split(":")
            reshard_at, reshard_stages = int(step_s), int(stages_s)
        except ValueError:
            raise SystemExit(f"--reshard-at wants STEP:STAGES, "
                             f"got {args.reshard_at!r}")
        if reshard_at < 1 or reshard_stages < 1:
            raise SystemExit("--reshard-at wants STEP >= 1 and "
                             f"STAGES >= 1, got {args.reshard_at!r}")
        if args.backend != "pipelined":
            raise SystemExit("--reshard-at requires --backend pipelined")
    if args.inject_fault and args.backend != "pipelined":
        raise SystemExit("--inject-fault requires --backend pipelined")
    if args.online and (reshard_at or detect):
        raise SystemExit("--online runs its own live loop — it composes "
                         "with faults, SLO and prefix caching but not with "
                         "the --reshard-at / --detect-failures drill loops")
    if args.arrival_rate <= 0:
        raise SystemExit(f"--arrival-rate must be > 0, "
                         f"got {args.arrival_rate}")
    if args.metrics_every < 1:
        raise SystemExit(f"--metrics-every must be >= 1, "
                         f"got {args.metrics_every}")
    if args.prefix_cache and args.prefill_mode == "exact":
        raise SystemExit("--prefix-cache needs chunked prefill (prefix "
                         "hits resume mid-prompt); drop "
                         "--prefill-mode exact")

    import dataclasses

    import numpy as np
    import torch

    from repro_torch.config import get_arch, reduced_config
    from repro_torch.core.cost_model import (PLATFORMS, min_throughput,
                                             profit_per_hour)
    from repro_torch.core.scheduler import optimal_microbatches
    from repro_torch.distributed.elastic import FailureDetector, FaultPlan
    from repro_torch.models import model as model_lib
    from repro_torch.core import pipeline as PL
    from repro_torch.models.common import Runtime, resolve_device
    from repro_torch.serving.backend import stage_devices
    from repro_torch.serving.engine import SLOConfig
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import LLM, EngineConfig, RequestOutput
    from repro_torch.serving.online import OnlineLLM
    from repro_torch.serving.request import SamplingParams

    cfg = get_arch(args.arch)
    if args.full:
        rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    else:
        cfg = reduced_config(cfg)
        rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
    mesh = args.mesh.split(",") if args.mesh else None
    device = resolve_device(args.device if args.device or not mesh
                            else mesh[0])
    # with a mesh the weights are drawn placed by stage (no card holds
    # more than its share and one layer)
    layer_devices = None if mesh is None else PL.layer_devices(
        cfg, stage_devices(mesh, args.stages, device))
    params = model_lib.init_params(cfg, args.seed, rt, device,
                                   layer_devices=layer_devices)

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
    fault_plan = FaultPlan.parse(args.inject_fault) if args.inject_fault \
        else None
    slo = None
    if args.slo_ttft > 0 or args.slo_itl > 0:
        slo = SLOConfig(ttft_target_s=args.slo_ttft,
                        itl_target_s=args.slo_itl)
        print(f"SLO admission: ttft_target={args.slo_ttft:.3f}s "
              f"itl_target={args.slo_itl:.3f}s")
    pipe = dict(backend=args.backend, transport=transport, mesh=mesh,
                schedule=args.schedule, wire_dtype=wire_dtype,
                fault_plan=fault_plan, prefix_cache=args.prefix_cache,
                slo=slo, trace=bool(args.trace) or None,
                strict=args.strict or None)
    if args.plan:
        t_s = measure_stage_time(cfg, params, rt, args.stages, device,
                                 mesh)
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
        max_pages = args.max_pages + -(-args.system_prompt // args.page_size)
        pool = PoolConfig(page_size=args.page_size,
                          n_local_pages=batch * max_pages + 1,
                          max_pages_per_seq=max_pages)
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
              f"{be.ranges[:-1]} on {[str(d) for d in be.stage_devices]}, "
              f"epilogue {be.ranges[-1]}; "
              f"{args.schedule} schedule, {wire_dtype} wire, "
              f"{be.transport.name} transport")
        head = be.head
        if head is not None:
            mib = head.numel() * head.element_size() / 2 ** 20
            print(f"tied unembedding: a {mib:.1f} MiB copy of the "
                  f"embedding on {head.device}, the last stage's device")
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
    if args.system_prompt:
        system = list(rng.randint(1, cfg.vocab_size, args.system_prompt))
        prompts = [system + p for p in prompts]
        print(f"system prompt: {args.system_prompt} tokens shared by every "
              "request")
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
    banner = _metrics_banner(engine, args) if args.metrics else None
    if args.online:
        outs = _serve_online(llm, OnlineLLM, prompts, sps, args, rng,
                             banner)
    elif reshard_at or detect or banner is not None:
        # the drills and the banner need a live loop: the engine stepped
        # by hand over the same workload
        outs = _serve_drill(engine, llm, RequestOutput, FailureDetector,
                            prompts, sps, args, reshard_at, reshard_stages,
                            detect, kills, banner)
    else:
        outs = llm.generate(prompts, sps)
    rep = llm.stats()
    if fault_plan is not None:
        print(f"faults: {len(fault_plan.triggered)} triggered, "
              f"{fault_plan.pending()} never reached (decode ticks lost "
              f"{rep['decode_ticks_lost']}, prefill chunks lost "
              f"{rep['prefill_chunks_lost']}, all injected again)")
    if "prefix_hits" in rep:
        print(f"prefix cache: {rep['prefix_hits']} hits, "
              f"{rep['prefix_hit_tokens']} prompt tokens not prefilled, "
              f"hit rate {rep['prefix_hit_rate']:.2f}, "
              f"{rep['prefix_cache_pages']} pages cached")
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
    if banner is not None:
        banner()
        print("metrics (Prometheus exposition):")
        print(banner.metrics.prometheus_text(), end="")
    if args.trace:
        from repro_torch.obs.timeline import write_chrome_trace
        trace = write_chrome_trace(engine.recorder, args.trace)
        od = trace["otherData"]
        print(f"trace: wrote {len(trace['traceEvents'])} timeline events "
              f"({od['recorder_events']} recorded, "
              f"{od['recorder_dropped']} dropped) to {args.trace} — open "
              "in https://ui.perfetto.dev")
    if engine.auditor is not None:
        print(f"strict: {engine.auditor.checks} invariant audits passed")

    n_b = optimal_microbatches(8, 0.08, args.latency)
    print(f"\nschedule report (8-stage pipeline, T_S=80ms, "
          f"L={args.latency * 1000:.0f}ms): N_B* = {n_b}")
    for name in ("mining", "ionet", "cloud"):
        p = PLATFORMS[name]
        print(f"  {name:8s} break-even {min_throughput(p.cost_per_hour):8.1f}"
              f" tok/s; at 450 tok/s profit/h = "
              f"${profit_per_hour(450, p.cost_per_hour):+.2f}")


def _metrics_banner(engine, args):
    """A callable that maps the engine's report onto a fresh
    ``obs.metrics.Metrics`` and prints the JAX serve CLI's ``[metrics]``
    line (tokens since the previous banner, finished requests, queue
    depth, decode tok/s); ``.metrics`` is the registry."""
    from repro_torch.obs.metrics import Metrics, update_from_engine

    metrics = Metrics()
    prev: dict = {}

    def banner() -> None:
        snap = update_from_engine(metrics, engine)
        d = Metrics.delta(prev, snap)
        prev.clear()
        prev.update(snap)
        print(f"[metrics] step={engine.stats.steps} "
              f"tokens+={d.get('repro_tokens_total', 0.0):.0f} "
              f"finished="
              f"{snap.get('repro_requests_finished_total', 0.0):.0f}"
              f"/{args.requests} "
              f"queue={snap.get('repro_queue_depth', 0.0):.0f} "
              f"decode tok/s="
              f"{snap.get('repro_decode_tok_per_s', 0.0):.1f}")

    banner.metrics = metrics
    return banner


def _serve_online(llm, online_cls, prompts, sps, args, rng, banner=None):
    """Submit the requests into the live engine at seeded Poisson arrival
    times (cooperative pump); print TTFT and ITL percentiles."""
    import numpy as np

    online = online_cls(llm=llm)
    arrivals = np.cumsum(rng.exponential(1.0 / args.arrival_rate,
                                         size=args.requests))
    sps_list = sps if isinstance(sps, list) else [sps] * args.requests
    streams, nxt = [], 0
    engine = llm.engine
    next_banner = args.metrics_every
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        while nxt < args.requests and arrivals[nxt] <= now:
            streams.append(online.submit(prompts[nxt], sps_list[nxt]))
            nxt += 1
        busy = online.step()
        if banner is not None and engine.stats.steps >= next_banner:
            banner()
            next_banner = engine.stats.steps + args.metrics_every
        if not busy:
            if nxt >= args.requests:
                break
            # idle before the next arrival: sleep up to it
            time.sleep(min(0.005, max(
                0.0, arrivals[nxt] - (time.perf_counter() - t0))))
    outs = [s.result() for s in streams]

    def pct(vals, q):
        return float(np.percentile(vals, q)) if vals else 0.0
    ttfts = [s.ttft_s for s in streams if s.ttft_s is not None]
    itls = [d for s in streams for d in s.inter_token_s()]
    print(f"online: {args.requests} requests over "
          f"{time.perf_counter() - t0:.2f}s (Poisson {args.arrival_rate:.1f} "
          f"req/s); TTFT p50={pct(ttfts, 50) * 1e3:.1f}ms "
          f"p99={pct(ttfts, 99) * 1e3:.1f}ms; ITL "
          f"p50={pct(itls, 50) * 1e3:.1f}ms p99={pct(itls, 99) * 1e3:.1f}ms")
    return outs


def _serve_drill(engine, llm, output_cls, detector_cls, prompts, sps, args,
                 reshard_at, reshard_stages, detect, kills, banner=None):
    """Step the engine by hand: reshard at ``reshard_at``, or when the
    failure detector declares a silenced device dead; print the metrics
    banner every ``--metrics-every`` steps."""
    seqs = engine.submit(llm._make_requests(prompts, sps))
    step, resharded = 0, False
    detector = None
    hb_t0 = time.monotonic()
    if detect:
        detector = detector_cls(timeout=args.detect_failures)
        for d in range(args.stages):            # one device a stage
            detector.beat(d, 0.0)
    while engine.step():
        step += 1
        if banner is not None and step % args.metrics_every == 0:
            banner()
        if reshard_at and step == reshard_at:
            old = engine.n_stages
            rplan = engine.reshard(n_stages=reshard_stages)
            resharded = True
            print(f"resharded at step {step}: {old} -> {reshard_stages} "
                  f"stages (batch_reshard={rplan['batch_reshard']}; "
                  + ", ".join(f"{k} {v * 1e3:.1f} ms"
                              for k, v in rplan["seconds"].items()) + ")")
        if detect:
            now = (float(step) if args.heartbeat_clock == "steps"
                   else time.monotonic() - hb_t0)
            for d in range(args.stages):
                if d not in kills or step <= kills[d]:
                    detector.beat(d, now)
            dead = detector.dead(now)
            if dead and not resharded:
                old = engine.n_stages
                engine.reshard(detector=detector, now=now)
                resharded = True
                print(f"failure detected at step {step} (dead devices "
                      f"{dead}): resharded {old} -> {engine.n_stages} "
                      "stage(s)")
    if reshard_at and not resharded:
        raise SystemExit(
            f"--reshard-at {args.reshard_at}: the workload finished after "
            f"{step} step(s), before step {reshard_at} — the drill never "
            "resharded; lower STEP or grow the workload")
    if detect and kills and not resharded:
        raise SystemExit(
            f"--detect-failures: the workload finished after {step} step(s) "
            "before any killed device missed its timeout — kill earlier, "
            "shorten the timeout, or grow the workload")
    return [output_cls.from_seq(s) for s in seqs]


if __name__ == "__main__":
    main()
