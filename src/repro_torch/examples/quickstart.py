"""Quickstart: load an assigned architecture at a reduced size, serve a few
requests offline through the ``LLM`` API, inspect the DeServe schedule
math (counterpart of the JAX package's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.config import list_archs
from repro_torch.core.cost_model import min_throughput
from repro_torch.core.scheduler import (optimal_microbatches, plan_schedule,
                                        schedule_diagram)
from repro_torch.examples import example_config
from repro_torch.serving.kv_cache import PoolConfig
from repro_torch.serving.llm import LLM, EngineConfig
from repro_torch.serving.request import SamplingParams


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print("registered architectures:", ", ".join(list_archs()))

    # 1. the LLM front end: a reduced-config model of an assigned arch
    #    (same family) behind the DeServe serving engine: paged KV and the
    #    double-buffer offload
    cfg, device = example_config("yi-9b", args.device)
    llm = LLM(cfg, config=EngineConfig(
        mb_size=2, num_microbatches=2,
        pool=PoolConfig(page_size=8, n_local_pages=32, n_global_pages=8,
                        max_pages_per_seq=8)), device=device)
    print(f"\nmodel: {llm.cfg.name}, {llm.cfg.param_count()/1e6:.1f}M params "
          f"on {llm.device}")

    # 2. generate: one greedy batch, then a sampled request on the side
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(1, llm.cfg.vocab_size, 6)) for _ in range(5)]
    outs = llm.generate(prompts, SamplingParams(temperature=0.0,
                                                max_new_tokens=12))
    for o in outs:
        print(f"  req {o.request_id}: prompt={o.prompt} -> {o.token_ids} "
              f"({o.finish_reason})")
    sampled = llm.generate([prompts[0]],
                           SamplingParams(temperature=0.9, top_p=0.95,
                                          max_new_tokens=12, logprobs=True))
    print(f"  sampled req {sampled[0].request_id}: {sampled[0].token_ids} "
          f"logprobs[0]={sampled[0].logprobs[0]:.2f}")
    print("engine report:", llm.stats())

    # 3. the paper's schedule math for a real deployment
    n_b = optimal_microbatches(n_stages=8, stage_time=0.08, latency=0.064)
    choice = plan_schedule(n_stages=8, stage_time=0.08, latency=0.064,
                           m_kv_bytes=2e9, kv_bytes_per_seq=15.7e6,
                           offload_bandwidth=6e9)
    print(f"\n8 stages @ 80ms, 64ms links: N_B* = {n_b}; planner chose "
          f"{choice.n_microbatches} microbatches x {choice.per_mb_batch} "
          f"seqs (util {choice.utilisation:.0%})")
    print(f"mining-platform break-even: "
          f"{min_throughput(0.35):.0f} tok/s")

    # 4. paper Figure 2(c): the bubble-free circular schedule
    print("\npaper Figure 2(c) (4 stages, L = T_S/2):")
    print(schedule_diagram(4, 6, stage_time=1.0, latency=0.5, ticks=16))
    print("vs. the naive N_B = N_M schedule:")
    print(schedule_diagram(4, 4, stage_time=1.0, latency=0.5, ticks=16))


if __name__ == "__main__":
    main()
