"""BENCHMARK.json against the contract's shape, and every file found by
name: a cell added as files and entries alone is picked up."""

import json
import re
import shutil

import pytest

from bench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"][:2] == ["python3", "bench/run.py"]
    assert bench["paths"] == ["bench"]
    assert 1 <= bench["run_seconds"] <= 51


def test_names_units_and_lines(bench):
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for e in bench["configs"] + bench["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for m in bench["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_every_cell_reports_what_its_metrics_move(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]

    def reports(metric, cell):
        return cell in metric.get("workloads", cells)

    for cell in cells:
        got = [m for m in e2e.values() if reports(m, cell)]
        assert "setup_s" in [m["name"] for m in got] and len(got) >= 2
        assert any(reports(m, cell) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_every_file_is_found_by_name(bench):
    used = set()
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        used.add(w["config"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert cell.traffic["source"] and cell.traffic["assumed"]
        for key in ("logit_gap_max", "min_tokens", "sample_tokens",
                    "sample_requests"):
            assert key in cell.limits
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.load_reader(m["name"]))
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"].startswith("bench/")
        conf = spec.read_json(spec.ROOT / c["file"])
        assert conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]


def test_a_cell_added_as_files_is_picked_up(tmp_path, bench):
    """A new mix, cell and per-layer metric, added as new files and new
    entries of a copy of BENCHMARK.json, with no file edited."""
    shutil.copytree(spec.BENCH, tmp_path / "bench")
    (tmp_path / "bench" / "traffic" / "dummy_mix.json").write_text(
        json.dumps({"name": "dummy_mix", "deck": 8,
                    "prompt": {"kind": "uniform", "lo": 8, "hi": 16},
                    "output": {"kind": "uniform", "lo": 4, "hi": 8},
                    "sampled_share": 0.5, "temperature": 0.8,
                    "top_p": 0.95, "backlog": 3}))
    (tmp_path / "bench" / "cells" / "yi9b.dummy_mix.json").write_text(
        json.dumps({"limits": {"logit_gap_max": 0.1, "min_tokens": 1,
                               "sample_tokens": 8, "sample_requests": 1},
                    "engine": {"rows": 2}}))
    (tmp_path / "bench" / "metrics" / "dummy.count.py").write_text(
        "def read(run):\n    return 7.0\n")
    added = json.loads(json.dumps(bench))
    added["workloads"].append({"name": "yi9b.dummy_mix", "config": "yi9b",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "test"})
    added["per_layer"].append({"name": "dummy.count", "unit": "rows",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "scheduler", "moves": "gen_tok_s",
                               "workloads": ["yi9b.dummy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(added))
    cell = spec.Cell(spec.load_benchmark(tmp_path), "yi9b.dummy_mix",
                     root=tmp_path, bench_dir=tmp_path / "bench")
    assert cell.engine["rows"] == 2
    assert cell.engine["prefill_chunk"] == 256      # from the config file
    assert cell.traffic["backlog"] == 3
    assert [m["name"] for m in cell.per_layer] == ["dummy.count"]
    assert spec.load_reader("dummy.count", tmp_path / "bench")(None) == 7.0
    # the cells that were there are unchanged
    old = spec.Cell(spec.load_benchmark(tmp_path), "yi9b.decode_heavy",
                    root=tmp_path, bench_dir=tmp_path / "bench")
    assert "dummy.count" not in [m["name"] for m in old.per_layer]


def test_a_mix_holds_no_engine_settings(tmp_path, bench):
    """Engine settings belong to the configuration and the cell; a mix
    that carries them is refused, so no model takes them unseen."""
    shutil.copytree(spec.BENCH, tmp_path / "bench")
    path = tmp_path / "bench" / "traffic" / "decode_heavy.json"
    mix = json.loads(path.read_text())
    path.write_text(json.dumps(dict(mix, engine={"rows": 2})))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="engine"):
        spec.Cell(spec.load_benchmark(tmp_path), "yi9b.decode_heavy",
                  root=tmp_path, bench_dir=tmp_path / "bench")
