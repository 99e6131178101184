"""The benchmark's tests import ``bench`` and ``repro_torch`` from the
checkout, and run torch on one CPU thread: the tiny cell's timed windows
then serve as much under several test workers as alone."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

torch.set_num_threads(1)
