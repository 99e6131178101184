"""Networked serving end to end: registry match -> DeploymentPlan ->
per-link simulated WAN transport -> the real engine on a virtual clock
(counterpart of the JAX package's ``examples/networked_serving.py``).

The same mixed greedy and sampled workload is served (1) over zero-cost
in-process links, (2) over the deployment's simulated WAN links with the
planner's N_B circular schedule, and (3) over the same links with the
round-flush (vLLM-PP) baseline schedule: the outputs are identical in all
three, while the virtual clock shows the circular schedule hiding the link
latency and round-flush paying it every token round.

The circular WAN run records a flight-recorder trace and writes it as a
Chrome trace (``--trace-out``, by default under the checkout's git-ignored
``build/``): open it in https://ui.perfetto.dev to see the schedule on
both clocks.

    PYTHONPATH=src python -m repro_torch.examples.networked_serving \\
        [--device cpu]
"""

import argparse
from pathlib import Path

import numpy as np

from repro_torch.core.scheduler import optimal_microbatches
from repro_torch.distributed.transport import (DeploymentPlan,
                                               SimulatedLinkTransport)
from repro_torch.examples import example_config
from repro_torch.framework.registry import Registry
from repro_torch.obs.timeline import write_chrome_trace
from repro_torch.serving.kv_cache import PoolConfig
from repro_torch.serving.llm import LLM, EngineConfig
from repro_torch.serving.request import SamplingParams

TRACE_OUT = (Path(__file__).resolve().parents[3] / "build" / "examples"
             / "networked_serving_trace.json")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trace-out", default=str(TRACE_OUT),
                    help="where the circular run's Chrome trace goes")
    args = ap.parse_args(argv)

    # --- a fleet registers; the registry builds the latency-minimising
    # pipeline; its match output IS the deployment plan -----------------
    reg = Registry()
    for i in range(2):
        reg.register_machine(f"west{i}", 24 << 30, "us-west", stake=30.0)
    reg.register_machine("east0", 24 << 30, "us-east", stake=30.0)
    task = reg.register_task("alice", "yi-9b", 55 << 30,
                             n_requests=64, max_price=0.9)
    match = reg.match(task.task_id)
    plan = DeploymentPlan.from_match(match)
    print(plan.describe())

    # --- the engine: reduced config, one device; the deployment's links
    # are simulated on a virtual clock, so this runs anywhere ------------
    cfg, device = example_config("yi-9b", args.device)
    pool = PoolConfig(page_size=8, n_local_pages=64, n_global_pages=0,
                      max_pages_per_seq=4)
    T = 0.016                                   # virtual stage seconds
    L = plan.max_link_latency
    n_star = optimal_microbatches(1, T, L)      # a 1-stage pipe here
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(1, cfg.vocab_size, 6))
               for _ in range(n_star)]
    sps = [SamplingParams(temperature=0.0 if i % 2 == 0 else 0.8,
                          max_new_tokens=12) for i in range(n_star)]

    def serve(label, n_b, schedule, transport, wire_dtype="fp32",
              trace=False):
        llm = LLM(cfg, config=EngineConfig(
            backend="pipelined", n_stages=1, mb_size=1,
            num_microbatches=n_b, pool=pool, offload=False,
            transport=transport, schedule=schedule, prefill_chunk=8,
            wire_dtype=wire_dtype, trace=trace), device=device)
        outs = llm.generate(prompts, sps)
        rep = llm.stats()
        vtps = rep.get("virtual_decode_tok_per_s")
        print(f"  {label:22s} N_B={n_b:2d} "
              + (f"{vtps:7.1f} tok/s on the virtual clock"
                 if vtps else "   (no clock: in-process links)"))
        if trace:
            Path(args.trace_out).parent.mkdir(parents=True, exist_ok=True)
            t = write_chrome_trace(llm.engine.recorder, args.trace_out)
            print(f"  ^ timeline: {len(t['traceEvents'])} events -> "
                  f"{args.trace_out} (open in https://ui.perfetto.dev)")
        return [tuple(o.token_ids) for o in outs], vtps

    print(f"\nserving over max link {L * 1000:.0f}ms "
          f"(virtual T_S={T * 1000:.0f}ms):")
    base, _ = serve("in-process", n_star, "circular", None)
    links = lambda: SimulatedLinkTransport.uniform(1, L, stage_time_s=T)
    circ, v_c = serve("simulated circular", n_star, "circular", links(),
                      trace=True)
    rf, v_rf = serve("simulated round-flush", 1, "round_flush", links())

    assert circ == base and rf == base, "transports must not change tokens"
    print(f"\noutputs bit-identical across all three runs; "
          f"circular hides the WAN: {v_c / v_rf:.1f}x round-flush")

    # --- the int8 wire codec: the same circular schedule with every
    # stage-boundary payload packed (1 byte an element + a scale a row).
    # Quantisation perturbs the logits, so tokens may drift off the fp32
    # run: report the agreement instead of asserting equality
    q, _ = serve("simulated circular int8", n_star, "circular", links(),
                 wire_dtype="int8")
    agree = np.mean([a == b for a, b in zip(q, base)])
    print(f"int8 wire codec: {agree * 100:.0f}% of streams identical to "
          f"fp32 on this reduced model (4x fewer payload bytes per link)")
    reg.release(match)


if __name__ == "__main__":
    main()
