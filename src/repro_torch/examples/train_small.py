"""End-to-end training: train a reduced model for a few hundred
steps on the synthetic pipeline with checkpointing (counterpart of the JAX
package's ``examples/train_small.py``).  The steps go through
``training.train_loop.train``: on a card the first runs eagerly and every
later one replays the captured step, which updates the weights and
moments in place.  The checkpoints go to a temporary directory under the
checkout's git-ignored ``build/``, removed at exit.

    PYTHONPATH=src python -m repro_torch.examples.train_small \\
        [--steps 300] [--device cpu]
"""

import argparse
import tempfile
from pathlib import Path

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, batches
from repro_torch.examples import example_config
from repro_torch.models.common import Runtime
from repro_torch.training import optimizer as O
from repro_torch.training import train_loop as TL

CKPT_PARENT = Path(__file__).resolve().parents[3] / "build" / "examples"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minitron-4b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg, device = example_config(args.arch, args.device, num_layers=4,
                                 d_model=args.d_model, vocab=512)
    rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
    ocfg = O.AdamWConfig(lr=3e-3, warmup_steps=args.steps // 20,
                         total_steps=args.steps)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      batch_size=args.batch)
    print(f"training {cfg.name} ({cfg.param_count()/1e6:.1f}M params) for "
          f"{args.steps} steps on the synthetic pipeline on {device}")

    CKPT_PARENT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=CKPT_PARENT) as d:
        mgr = CheckpointManager(d, keep=2)
        params, opt_state, res = TL.train(
            cfg, rt, ocfg, batches(dcfg), steps=args.steps,
            checkpoint_mgr=mgr, checkpoint_every=100,
            log_every=max(10, args.steps // 10), device=device)
        print(f"\nloss: {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
              f"({res.tokens_per_second:.0f} tok/s)")
        print(f"checkpoints kept: {mgr.steps()}")
    assert res.losses[-1] < res.losses[0], "training failed to reduce loss"


if __name__ == "__main__":
    main()
