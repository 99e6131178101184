"""Seeded weights on the device, in the port's parameter layout, made in a
few large calls.

The layout is the configuration's architecture's: its module
``bench/reference/<name>.py`` gives, through ``layout(conf)``, every
matrix's path, shape, fan-in and dtype in draw order, and every norm
weight's path and shape.  One rule draws them for every architecture.
Every matrix is normal with a standard deviation of ``1 / sqrt(fan_in)``,
and every norm's ``w`` normal with a standard deviation of ``NORM_STD``
(norms are stored as ``w`` for a scale of ``1 + w``), so that a norm
whose scale is lost shows in the logits.  The matrices of one fan-in and
dtype, grouped in the order their first member appears, are views of one
flat tensor drawn by one ``torch.randn`` call from a generator on the
device seeded with ``--seed``, and scaled by one multiply; the norms, one
more such tensor drawn last.  Both the program and the plain reference are
handed these tensors.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict

import torch

NORM_STD = 0.1


def _put(tree: dict, path: tuple, value) -> None:
    """Set ``tree[path]``, making the dicts (string keys) and lists
    (integer keys) on the way."""
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        child = [] if isinstance(nxt, int) else {}
        if isinstance(node, list):
            node.extend(None for _ in range(key + 1 - len(node)))
            if node[key] is None:
                node[key] = child
        else:
            node.setdefault(key, child)
        node = node[key]
    if isinstance(node, list):
        node.extend(None for _ in range(path[-1] + 1 - len(node)))
    node[path[-1]] = value


def make_params(arch, conf: dict, seed: int, device,
                dtype=torch.bfloat16) -> dict:
    """The weights of a configuration file's model, from ``seed``, in the
    layout of ``arch``, the configuration's module."""
    matrices, norms = arch.layout(conf)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    tree: dict = {}
    groups: Dict[tuple, list] = defaultdict(list)
    for path, shape, fan_in, dt in matrices:
        groups[(fan_in, dt)].append((path, shape))
    for (fan_in, dt), members in groups.items():
        tdt = torch.float32 if dt == "float32" else dtype
        _draw(tree, members, gen, tdt, device, 1.0 / math.sqrt(fan_in))
    _draw(tree, norms, gen, dtype, device, NORM_STD)
    return tree


def _draw(tree: dict, members: list, gen, dtype, device,
          scale: float) -> None:
    """One ``torch.randn`` for every ``(path, shape)`` of ``members``,
    scaled by ``scale`` and laid out as views in order."""
    total = sum(math.prod(shape) for _, shape in members)
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    flat.mul_(scale)
    off = 0
    for path, shape in members:
        n = math.prod(shape)
        _put(tree, path, flat[off:off + n].view(shape))
        off += n
