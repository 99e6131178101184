"""A CPU-sized cell for the harness's tests: a two-layer yi-shaped model,
short prompts and outputs, written into a temporary benchmark folder that
holds the real metric readers and references."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench import spec

TINY_CONFIG = {
    "name": "tiny", "source": "test", "model_type": "llama",
    "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 2,
    "vocab_size": 256, "max_position_embeddings": 4096,
    "rope_theta": 5000000.0, "rms_norm_eps": 1e-05,
    "tie_word_embeddings": False, "reduced": [], "dtype": "bfloat16",
    "reference": "llama",
    "program": {"arch": "yi-9b", "set": {
        "d_model": 64, "d_ff": 128, "num_heads": 4, "num_kv_heads": 2,
        "head_dim": 16, "num_layers": 2, "vocab_size": 256,
        "norm_eps": 1e-05}},
    "engine": {"backend": "local", "microbatches": 1, "rows": 4,
               "page_size": 8, "prefill_chunk": 16, "prefill_rows": 1}}
TINY_MIX = {"name": "tiny", "deck": 16,
            "prompt": {"kind": "log_uniform", "lo": 4, "hi": 40},
            "output": {"kind": "uniform", "lo": 4, "hi": 24},
            "sampled_share": 0.5, "temperature": 0.8, "top_p": 0.95,
            "top_k": 0, "backlog": "rows"}
TINY_LIMITS = {"logit_gap_max": 0.05, "min_tokens": 8,
               "sample_tokens": 48, "sample_requests": 1000}


def make_bench(tmp: Path, limits: dict = None) -> dict:
    """A benchmark folder under ``tmp`` with the tiny cell ``tiny.mix``;
    returns its BENCHMARK dict (the real metric readers and references are
    copied)."""
    bench_dir = tmp / "bench"
    for sub in ("configs", "traffic", "cells"):
        (bench_dir / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "reference"):
        shutil.copytree(spec.BENCH / sub, bench_dir / sub,
                        dirs_exist_ok=True)
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    (bench_dir / "traffic" / "mix.json").write_text(json.dumps(TINY_MIX))
    (bench_dir / "cells" / "tiny.mix.json").write_text(
        json.dumps({"limits": limits or TINY_LIMITS}))
    real = spec.load_benchmark()
    bench = {"configs": [{"name": "tiny", "source": "test",
                          "file": "bench/configs/tiny.json", "reduced": [],
                          "why": "test"}],
             "workloads": [{"name": "tiny.mix", "config": "tiny",
                            "traffic": "mix", "chips": 1, "why": "test"}],
             "end_to_end": [dict(m, workloads=["tiny.mix"]) for m in
                            real["end_to_end"]],
             "per_layer": [dict(m, workloads=["tiny.mix"]) for m in
                           real["per_layer"]]}
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


def tiny_cell(tmp: Path, limits: dict = None) -> spec.Cell:
    bench = make_bench(tmp, limits)
    return spec.Cell(bench, "tiny.mix", root=tmp, bench_dir=tmp / "bench")
