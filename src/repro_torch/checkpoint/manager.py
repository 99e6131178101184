"""Atomic, resumable checkpoints of trees of tensors (counterpart of
``repro.checkpoint.manager``, with its on-disk contract).

Layout: ``<root>/step_<N>/`` (N zero-padded to 8 digits) with one ``.npy``
a leaf, named by its path (``repro_torch.tree``: ``k:<key>``,
``i:<index>``, ``n:<field>`` joined by ``__``, as the JAX manager names
them), and ``manifest.json`` (each leaf's shape and dtype, the step, the
caller's metadata).  A save writes ``step_<N>.tmp`` and renames it only
after the manifest is fsynced, so a crash mid-save never leaves a
half-written checkpoint where ``latest_step`` finds it; ``keep`` bounds
how many are retained.  A bfloat16 leaf is stored as float32 (exact; numpy
has no bfloat16) and its manifest dtype says bfloat16.  ``restore``
validates every shape against the template and puts each leaf on the
template leaf's device and dtype.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import List, Optional

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, unflatten_like

_SEP = "__"


def _key(path: tuple) -> str:
    return _SEP.join(path)


def _to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return str(np.asarray(t).dtype)


class CheckpointManager:
    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    # -- save -----------------------------------------------------------

    def save(self, step: int, tree, metadata: Optional[dict] = None) -> str:
        final = os.path.join(self.root, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = leaves_with_path(tree)
        manifest = {
            "step": step,
            "leaves": {_key(p): {"shape": list(t.shape),
                                 "dtype": _dtype_name(t)} for p, t in flat},
            "metadata": metadata or {},
        }
        for path, t in flat:
            np.save(os.path.join(tmp, _key(path) + ".npy"), _to_numpy(t))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._retain()
        return final

    # -- restore --------------------------------------------------------

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.root, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template, step: Optional[int] = None):
        """Restore into the structure of ``template`` (shapes validated;
        each leaf on its template leaf's device and dtype).  Returns (tree,
        metadata)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out = []
        for path, leaf in leaves_with_path(template):
            key = _key(path)
            arr = np.load(os.path.join(d, key + ".npy"))
            want = tuple(leaf.shape)
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"checkpoint leaf {key}: shape {arr.shape} != {want}")
            out.append(torch.from_numpy(arr).to(device=leaf.device,
                                                dtype=leaf.dtype))
        return unflatten_like(template, out), manifest["metadata"]

    # -- retention ------------------------------------------------------

    def _retain(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)
