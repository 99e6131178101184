"""Training driver (counterpart of ``repro.launch.train``): train a reduced
(or, with ``--full-size``, the published) arch on the synthetic pipeline,
float32, with checkpoint / restart fault tolerance.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch gemma3-1b --steps 4 --batch 2 --seq 16 [--resume] \\
      [--compress int8]

It runs on ``cuda`` unless ``--device`` names another device, through
``training.train_loop.train``: on a card the first step runs eagerly and
every later one replays the captured step (the weights and moments
updated in place, as the JAX driver's jitted step donates them).  As in
the JAX driver, ``--resume`` restores the latest checkpoint's parameters
and optimizer state and then draws batches from the start of the data
stream.
"""

from __future__ import annotations

import argparse
import os

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import get_arch, reduced_config
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.distributed.compression import Compressor
from repro_torch.models import model as model_lib
from repro_torch.models.common import Runtime, resolve_device
from repro_torch.training import optimizer as opt_lib
from repro_torch.training import train_loop


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress", choices=["none", "int8", "topk"],
                    default="none")
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (cpu runs the plain versions "
                         "of the kernels)")
    return ap.parse_args(argv)


def setup(args: argparse.Namespace):
    """(device, cfg, rt, ocfg, dcfg) for the parsed flags: float32 weights
    and activations, AdamW at ``--lr`` with a warmup of ``max(10, steps /
    20)`` and a cosine over ``--steps``, the synthetic stream from
    ``--seed``."""
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if not args.full_size:
        cfg = reduced_config(cfg)
    rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
    ocfg = opt_lib.AdamWConfig(lr=args.lr, warmup_steps=max(10, args.steps
                                                            // 20),
                               total_steps=args.steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      batch_size=args.batch, accum_steps=args.accum,
                      seed=args.seed)
    return device, cfg, rt, ocfg, dcfg


def main(argv=None) -> None:
    args = parse_args(argv)
    device, cfg, rt, ocfg, dcfg = setup(args)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.batch}x{args.seq} on {device}")
    data = batches(dcfg)

    params = model_lib.init_params(cfg, args.seed, rt, device)
    opt_state = opt_lib.init(ocfg, params)
    mgr = CheckpointManager(os.path.join(args.ckpt_dir, cfg.name), keep=3)
    if args.resume and mgr.latest_step() is not None:
        (restored, _) = mgr.restore({"params": params,
                                     "opt_state": opt_state})
        params, opt_state = restored["params"], restored["opt_state"]
        print(f"resumed from step {int(opt_state.step)}")

    comp = None
    if args.compress != "none":
        comp = Compressor(method=args.compress)

    params, opt_state, res = train_loop.train(
        cfg, rt, ocfg, data, steps=args.steps, params=params,
        opt_state=opt_state, accum_steps=args.accum, compressor=comp,
        checkpoint_mgr=mgr, checkpoint_every=args.ckpt_every,
        log_every=args.log_every)
    print(f"done: loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}, "
          f"{res.tokens_per_second:.0f} tok/s")
    mgr.save(int(opt_state.step), {"params": params, "opt_state": opt_state},
             {"final_loss": res.losses[-1]})


if __name__ == "__main__":
    main()
