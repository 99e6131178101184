"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  The library is built from the checkout's sources at
first use, into ``build/kernels/`` at the repository root (listed in
``.gitignore``); its file name carries a hash of the source, the
``csrc`` headers it includes and the flags, so an edited source or header
never loads a stale library.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class BuildInfo:
    """What a build did: library path, seconds, and nvcc's ptxas report."""
    path: Path
    seconds: float
    log: str
    cached: bool


_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
            "kernels are built from source on first use and need the CUDA "
            "toolkit")
    return path


def _library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the headers of
    ``csrc`` that the source includes, and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = re.findall(rb'^#include "([^"]+)"', src, re.MULTILINE)
    data = src + b"".join((CSRC / h.decode()).read_bytes() for h in headers)
    digest = hashlib.sha256(data + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_many(names: Sequence[str]) -> Dict[str, BuildInfo]:
    """Compile ``csrc/<name>.cu`` for every name that has no library of the
    same source and flags yet, one ``nvcc`` per source, all started
    together; returns each name's :class:`BuildInfo`."""
    out: Dict[str, BuildInfo] = {}
    running = {}
    for name in names:
        path = _library_path(name)
        if path.exists():
            out[name] = BuildInfo(path, 0.0, "", cached=True)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        # nvcc's report goes to a file: pipes read one process at a time
        # could fill up and stall the others
        log = path.with_suffix(f".{os.getpid()}.log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")], stdout=fh, stderr=fh)
        running[name] = (proc, path, tmp, log, time.perf_counter())
    failed = []
    for name, (proc, path, tmp, log, t0) in running.items():
        proc.wait()
        seconds = time.perf_counter() - t0
        report = log.read_text()
        log.unlink()
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {name}.cu (exit "
                          f"{proc.returncode}):\n{report}")
            continue
        os.replace(tmp, path)       # atomic: no loader sees a partial file
        out[name] = BuildInfo(path, seconds, report, cached=False)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> BuildInfo:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags exists; returns the build's :class:`BuildInfo`."""
    return build_many([name])[name]


def loaded() -> Dict[str, ctypes.CDLL]:
    """The libraries :func:`load` has loaded in this process, by name (a
    copy; the strict auditor pins each one's path and handle)."""
    return dict(_LOADED)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name).path))
    return lib
