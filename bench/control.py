"""The readings that the limits of ``correct`` are set from, on several
seeds in one process.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 8 [--control 0|1]

For each seed it runs the cell as ``run.py`` does (weights, warm-up until
the batch is full, a window of ``--seconds``), draws the sample that
``run.py`` would judge, and prints one JSON line: the program's
``logit_gap_max`` and whether ``check.judge`` finds it ``correct``; with
``--control 1`` also the control's ``control_gap`` (the reference at
float8 in the program's place, at the same positions) and
``control_correct``, the control put through ``check.judge`` in the
program's place.  The benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench.run import set_environment  # noqa: E402


def readings(cell, seed: int, seconds: float, device, control: bool) -> dict:
    """One seed's readings (see the module docstring)."""
    import torch

    from bench import check, serve

    runner = serve.Runner(cell, seed, device)
    runner.warm_up()
    phase = runner.run_phase(seconds)
    finished = runner.finished_greedy()
    short = runner.short_finishes()
    runner.free_engine()
    lim = cell.limits
    sample = check.draw_sample(finished, seed, int(lim["sample_tokens"]),
                               int(lim["sample_requests"]))
    t0 = time.perf_counter()
    out = check.gaps(cell.arch, runner.params, cell.config, sample,
                     control=control) if sample else {}
    ok, _ = check.judge(out, lim, short)
    if control and sample:
        out["control_correct"], _ = check.judge(
            dict(out, logit_gap_max=out["control_gap"]), lim, short)
    out.update(seed=seed, correct=ok, short_finishes=short,
               window_s=phase.seconds, reference_s=time.perf_counter() - t0,
               requests=len(sample))
    del runner
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    set_environment(ROOT)

    import torch

    from bench import spec

    cell = spec.Cell(spec.load_benchmark(ROOT), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s)",
              file=sys.stderr)
        return 2
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(readings(cell, seed, args.seconds, "cuda:0",
                                  bool(args.control))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
