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
"""

from __future__ import annotations

import argparse


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
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    from repro_torch.config import get_arch, reduced_config
    from repro_torch.models.common import Runtime
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import LLM, EngineConfig
    from repro_torch.serving.request import SamplingParams

    cfg = get_arch(args.arch)
    if args.full:
        rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    else:
        cfg = reduced_config(cfg)
        rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
    batch = args.mb_size * args.microbatches
    pool = PoolConfig(page_size=args.page_size,
                      n_local_pages=batch * args.max_pages + 1,
                      max_pages_per_seq=args.max_pages)
    econfig = EngineConfig(mb_size=args.mb_size,
                           num_microbatches=args.microbatches, pool=pool,
                           seed=args.seed, prefill_chunk=args.prefill_chunk,
                           max_prefill_tokens_per_tick=args.max_prefill_tokens,
                           prefill_mode=args.prefill_mode)
    llm = LLM(cfg, config=econfig, rt=rt, device=args.device)
    engine = llm.engine
    print(f"arch={cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
          f"params={cfg.param_count() / 1e6:.1f}M dtype={rt.param_dtype} "
          f"device={engine.device}")
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


if __name__ == "__main__":
    main()
