"""Everything a run needs, found by name: the cell in ``BENCHMARK.json``,
its configuration file, its traffic mix, its own settings and limits, and
the readers of its per-layer metrics.

Adding a configuration, a mix, a cell or a per-layer metric means adding
files and entries: nothing here lists them.

- ``BENCHMARK.json`` ``workloads``: a cell is ``{config, traffic, chips}``;
- ``configs`` entry ``file``: the configuration's sizes and its ``engine``
  block (batch rows, microbatches, page size, chunk, backend);
- ``bench/traffic/<traffic>.json``: the mix (lengths, sampled share,
  backlog) and nothing of the deployment, so that any configuration can
  take it;
- ``bench/cells/<cell>.json``: the cell's limits for ``correct`` and an
  optional ``engine`` block that overrides the configuration's, the one
  place where a cell's deployment departs from its configuration's;
- ``bench/metrics/<metric>.py``: a per-layer metric's reader, a function
  ``read(run)`` that returns a number or None;
- ``bench/reference/<name>.py``, named by the configuration's
  ``reference``: its architecture (the plain reference, the weight
  layout, the operations a token, the published keys to check; see
  ``bench/README.md``).
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT,
                 bench_dir: Path = BENCH):
        if not NAME.match(name):
            raise ValueError(f"bad cell name {name!r}")
        self.name = name
        self.entry = _by_name(bench["workloads"], name, "workload")
        self.chips = int(self.entry["chips"])
        conf_entry = _by_name(bench["configs"], self.entry["config"],
                              "configuration")
        self.config = read_json(root / conf_entry["file"])
        self.arch = load_arch(self.config["reference"], bench_dir)
        self.traffic = read_json(bench_dir / "traffic" /
                                 f"{self.entry['traffic']}.json")
        if "engine" in self.traffic:
            raise ValueError(f"traffic {self.entry['traffic']!r} holds "
                             "engine settings; they go in the cell's file")
        cell_path = bench_dir / "cells" / f"{name}.json"
        self.cell = read_json(cell_path) if cell_path.exists() else {}
        self.engine = {**self.config.get("engine", {}),
                       **self.cell.get("engine", {})}
        self.limits: Dict[str, float] = dict(self.cell.get("limits", {}))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.bench_dir = bench_dir


def _load_file(path: Path, prefix: str, name: str) -> ModuleType:
    mod_name = prefix + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, bench_dir: Path = BENCH) -> Callable:
    """``bench/metrics/<name>.py``'s ``read``."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    return _load_file(bench_dir / "metrics" / f"{name}.py", "bench_metric_",
                      name).read


def load_arch(name: str, bench_dir: Path = BENCH) -> ModuleType:
    """``bench/reference/<name>.py``, the module of a configuration's
    architecture."""
    if not NAME.match(name):
        raise ValueError(f"bad reference name {name!r}")
    return _load_file(bench_dir / "reference" / f"{name}.py", "bench_arch_",
                      name)
