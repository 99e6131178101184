"""The port's examples (``repro_torch.examples``), each run on the CPU as
``python -m repro_torch.examples.<name> --device cpu`` at its smallest
arguments, in a subprocess with a time limit of ``LIMIT_S`` seconds (each
takes a few seconds of one core); each exits 0 and prints its key lines.
Without ``--device`` an example runs on ``cuda`` and raises here."""

import os
import subprocess
import sys

import pytest

LIMIT_S = 180
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# example: (extra arguments, lines its output must hold)
EXAMPLES = {
    "quickstart": ([], ["registered architectures:", "engine report:",
                        "N_B* = ", "paper Figure 2(c)"]),
    "offline_serving": (["--requests", "4", "--max-new", "6"],
                        ["served 4 requests", "offload swaps:",
                         "profit/hour"]),
    "offline_serving_pipelined": (
        ["--arch", "yi-9b", "--backend", "pipelined", "--stages", "2",
         "--requests", "4", "--max-new", "6"],
        ["[pipelined]: served 4 requests"]),
    "networked_serving": ([], ["outputs bit-identical across all three runs",
                               "int8 wire codec:", "^ timeline:"]),
    "train_small": (["--steps", "20", "--batch", "4", "--seq", "32"],
                    ["loss: ", "checkpoints kept:"]),
    "decentralized_market": ([], ["payment released:", ": dismissed",
                                  "miner7: slashed"]),
}


def _run(module, args, tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{module}", *args],
        env=env, capture_output=True, text=True, timeout=LIMIT_S,
        cwd=tmp_path)


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    module = name.replace("_pipelined", "")
    args, lines = EXAMPLES[name]
    if module == "networked_serving":
        args = args + ["--trace-out", str(tmp_path / "trace.json")]
    r = _run(module, ["--device", "cpu", *args], tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    for line in lines:
        assert line in r.stdout, (line, r.stdout[-2000:])


def test_examples_run_on_the_card_unless_asked(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is legitimate")
    r = _run("quickstart", [], tmp_path)
    assert r.returncode != 0 and "device='cpu'" in r.stderr


@pytest.mark.parametrize("arch,reduce", [
    ("yi-9b", {}), ("gemma3-1b", {}), ("llama3-70b", {}),
    ("minitron-4b", dict(num_layers=4, d_model=128, vocab=512))])
def test_example_config_widens_heads_for_the_kernels_only_on_the_card(
        arch, reduce, monkeypatch):
    """On the CPU an example keeps the JAX script's reduced config; on a
    CUDA device its heads are widened to the kernels' smallest head dim
    (the rest of the shrinking rule unchanged)."""
    import torch

    import repro_torch.examples as ex
    from repro_torch.config import get_arch, reduced_config
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    cfg, dev = ex.example_config(arch, "cpu", **reduce)
    assert dev.type == "cpu" and cfg == reduced_config(get_arch(arch),
                                                       **reduce)
    assert cfg.head_dim < min(HEAD_DIMS)
    monkeypatch.setattr(ex, "resolve_device",
                        lambda device: torch.device("cuda"))
    wide, dev = ex.example_config(arch, None, **reduce)
    assert dev.type == "cuda" and wide.head_dim == min(HEAD_DIMS)
    assert (wide.num_heads, wide.num_kv_heads, wide.num_layers,
            wide.vocab_size) == (cfg.num_heads, cfg.num_kv_heads,
                                 cfg.num_layers, cfg.vocab_size)
