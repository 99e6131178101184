"""One run of one benchmark cell of ``repro_torch``.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  It puts the checkout and ``src`` on the
path itself, keeps every build and kernel cache inside the checkout
(``build/``), builds the cell's engine with weights made on the card from
``--seed``, warms up until the batch is full, measures for ``--seconds``
and, with ``--trace 1``, traces a further slice of steps under
``torch.profiler``.  Then it checks the served greedy tokens against the
plain reference and prints, as its last line, one JSON object: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics (``--trace
1``), ``correct``, and the numbers compared with their limits, which are
also the last lines on standard error.

It exits with 2 and prints no result when the cell's cards are not
there, and with 3 when a module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TRACE_SECONDS = 3.0


def set_environment(root: Path) -> None:
    """Caches at fixed paths inside the checkout; no library loads JAX."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" /
                                             "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)


class Run:
    """What a metric's reader reads: the window's phase and, in a traced
    run, the traced slice's phase and its timeline."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def card_info():
    """(name, power limit) of the first card as ``nvidia-smi`` reads them,
    or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: Path = ROOT) -> dict:
    """Run the cell once; the result object (see the module docstring)."""
    import torch

    from bench import check, serve, spec
    from bench import timeline as timeline_lib

    t_build = time.perf_counter()
    runner = serve.Runner(cell, seed, device)
    t_engine = time.perf_counter()
    warm_steps = runner.warm_up()
    phase = runner.run_phase(seconds)
    setup = {"imports_s": t_build - t_start, "build_s": t_engine - t_build,
             "warmup_s": phase.t0 - t_engine, "warmup_steps": warm_steps,
             "capture_s": runner.capture_s()}
    print(f"set-up {json.dumps(setup)}", file=sys.stderr)
    setup_s = phase.t0 - t_start
    traced = tl = None
    if trace:
        path = serve.trace_path(root)
        traced = runner.traced_phase(TRACE_SECONDS, path)
        tl = timeline_lib.read(path)
        os.remove(path)
    if phase.captures1 != phase.captures0:
        print(f"warning: {phase.captures1 - phase.captures0} step(s) "
              "captured inside the window", file=sys.stderr)
    peak = runner.memory_peak()
    finished = runner.finished_greedy()
    short = runner.short_finishes()
    attempted = runner.attempted()
    pages_seq = runner.pages_seq
    runner.free_engine()

    lim = cell.limits
    sample = check.draw_sample(finished, seed, int(lim["sample_tokens"]),
                               int(lim["sample_requests"]))
    readings = check.gaps(cell.arch, runner.params, cell.config,
                          sample) if sample else {}
    ok, checks = check.judge(readings, lim, short)

    dtype = getattr(torch, cell.config["dtype"])
    run = Run(phase=phase, traced=traced, timeline=tl, sizes=runner.sizes,
              arch=cell.arch, setup_s=setup_s, cards=cell.chips,
              pages_seq=pages_seq,
              esize=torch.empty((), dtype=dtype).element_size(),
              dtype_name=cell.config["dtype"], cell=cell)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.load_reader(m["name"], cell.bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(peak)}
    if tl is not None:
        info["busy_s"] = tl.mean_busy_s(cell.chips)
        info["window_s"] = tl.window_s
    result = {"correct": bool(ok), "attempted": int(attempted),
              "failed": int(short), "metrics": metrics, "device": info}
    if tl is not None:
        result["breakdown"] = timeline_lib.breakdown(tl, cell.chips)
    result["window"] = {"seconds": phase.seconds, "steps": len(phase.steps),
                        "decode_calls": len(phase.decode),
                        "prefill_calls": len(phase.prefill),
                        "gaps": len(phase.gaps),
                        "captures_in_window":
                            phase.captures1 - phase.captures0,
                        "readings": readings,
                        "sampled_requests": len(sample), "setup": setup}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment(ROOT)

    import torch

    from bench import guard, spec

    cell = spec.Cell(spec.load_benchmark(ROOT), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); {seen} "
              "visible", file=sys.stderr)
        return 2
    card = card_info()
    print(f"card: {card}", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", T_START)
    result["card"] = card
    checks = result.pop("checks")
    result["checks"] = checks
    bad = guard.forbidden_modules(sys.modules)
    if bad:
        print("modules of JAX or of the JAX package were loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
