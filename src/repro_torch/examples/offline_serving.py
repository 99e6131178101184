"""End-to-end offline serving: serve a batched request workload
through the full DeServe stack via the ``LLM`` API and account
profitability (counterpart of the JAX package's
``examples/offline_serving.py``).

This is the paper's §5 workload at a reduced size: random prompt and
generation lengths, stats over the run, with a *mixed* sampling workload:
greedy, temperature, top-k and top-p requests all ride the same
continuously batched pipe, each under its own ``SamplingParams``.  Swap
--arch for any registered architecture; --backend pipelined serves the
same engine through the §4.3 circular pipeline, every stage on the
engine's device (``EngineConfig(mesh=)`` places them on others).

    PYTHONPATH=src python -m repro_torch.examples.offline_serving \\
        [--arch gemma3-1b] [--backend pipelined --stages 2] [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.cost_model import PLATFORMS, profit_per_hour
from repro_torch.examples import example_config
from repro_torch.serving.kv_cache import PoolConfig
from repro_torch.serving.llm import LLM, EngineConfig
from repro_torch.serving.request import SamplingParams


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--backend", default="local",
                    choices=["local", "pipelined"])
    ap.add_argument("--stages", type=int, default=1,
                    help="pipeline stages for --backend pipelined (the "
                         "reduced archs fit 1-2 stages)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg, device = example_config(args.arch, args.device)
    llm = LLM(cfg, config=EngineConfig(
        mb_size=2,
        num_microbatches=max(3, args.stages),
        pool=PoolConfig(page_size=8, n_local_pages=48, n_global_pages=12,
                        max_pages_per_seq=8),
        offload=True, backend=args.backend, n_stages=args.stages),
        device=device)

    rng = np.random.RandomState(1)
    prompts = [list(rng.randint(1, llm.cfg.vocab_size, rng.randint(4, 20)))
               for _ in range(args.requests)]
    # one engine, four sampling policies: each request keeps its own
    policies = [
        SamplingParams(temperature=0.0, max_new_tokens=args.max_new),
        SamplingParams(temperature=0.8, top_p=0.95,
                       max_new_tokens=args.max_new, logprobs=True),
        SamplingParams(temperature=1.0, top_k=16,
                       max_new_tokens=args.max_new),
        SamplingParams(temperature=0.9, top_p=0.9, top_k=32,
                       max_new_tokens=args.max_new),
    ]
    sps = [policies[i % len(policies)] for i in range(args.requests)]

    outs = llm.generate(prompts, sps)
    for o in outs[:4]:
        lp = (f" mean_lp={np.mean(o.logprobs):.2f}"
              if o.logprobs else "")
        print(f"  req {o.request_id}: {len(o.token_ids)} toks, "
              f"finish={o.finish_reason}{lp}")

    rep = llm.stats()
    print(f"{llm.cfg.name} [{rep['backend']}]: served {rep['finished']} "
          f"requests, {rep['total_tokens']} tokens in "
          f"{rep['wall_time_s']:.1f}s ({rep['decode_tok_per_s']:.1f} decode "
          f"tok/s on {llm.device}; mean latency "
          f"{rep['mean_latency_steps']:.0f} steps)")
    print(f"offload swaps: {rep['swaps']}")
    print("\nif this were an 8x4090 mining-rate pipeline at 450 tok/s:")
    for name in ("mining", "ionet", "cloud"):
        print(f"  {name:8s} profit/hour "
              f"${profit_per_hour(450, PLATFORMS[name].cost_per_hour):+7.2f}")


if __name__ == "__main__":
    main()
