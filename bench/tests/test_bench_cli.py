"""The command line: no card, no result; on a card (``cuda`` marker) one
short run of a cell gives the result line the contract asks for."""

import json
import subprocess
import sys

import pytest

from bench import spec


def run_cli(*args, cwd=spec.ROOT, timeout=900):
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs on the card")


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the refusal of a machine without a card")


def test_refuses_without_a_card(no_card):
    p = run_cli("--workload", "yi9b.decode_heavy", "--seed", "1",
                "--seconds", "1", "--trace", "0", timeout=120)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_cell_result_on_the_card(card, trace):
    p = run_cli("--workload", "yi9b.decode_heavy", "--seed",
                str(2**31 + 5), "--seconds", "3", "--trace", trace)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
    want = spec.Cell(spec.load_benchmark(), "yi9b.decode_heavy")
    names = {m["name"] for m in (want.per_layer if trace == "1"
                                 else want.end_to_end)}
    assert set(res["metrics"]) <= names
    if trace == "0":
        assert set(res["metrics"]) == names
    else:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert list(res)[-1] == "checks"
