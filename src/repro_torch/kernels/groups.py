"""Query-group regrouping, so that the attention kernels take any GQA group
size ``G = H / Hk``.

The kernels are instantiated for a few group sizes (``sizes``), as the
TPU kernels are not.  For another G the wrapper cuts each kv head's group
of query heads into launches of at most ``max(sizes)`` heads, pads the
last launch's group with zero query rows up to the next size the kernel
takes, launches the kernel once a launch, and drops the pad rows from the
outputs.  A zero query row is an ordinary query (uniform scores): it
costs the kernel work but never reaches a real head's output, since every
head's softmax is its own.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F


def group_plan(g: int, sizes: Sequence[int]) -> List[Tuple[int, int, int]]:
    """``[(first head, heads, padded group size), ...]``, one entry a launch:
    whole launches of ``max(sizes)`` heads, then the rest padded to the
    smallest size in ``sizes`` that holds it.  A G in ``sizes`` is one
    launch with no padding."""
    if g < 1:
        raise ValueError(f"group size {g} < 1")
    top = max(sizes)
    plan = []
    for start in range(0, g, top):
        n = min(top, g - start)
        plan.append((start, n, min(s for s in sizes if s >= n)))
    return plan


def split_groups(q: torch.Tensor, hk: int, plan, head_axis: int
                 ) -> List[torch.Tensor]:
    """One contiguous query tensor a launch: the heads of each kv head's
    group that the launch owns, then zero rows up to its padded size.  The
    head axis of ``q`` (``hk * G`` heads, group-major as the kernels lay
    them out) becomes ``hk * padded``."""
    qg = q.unflatten(head_axis, (hk, -1))
    # F.pad counts (left, right) pairs from the last axis backwards
    inner = [0, 0] * (q.dim() - head_axis - 1)
    parts = []
    for start, n, padded in plan:
        part = qg.narrow(head_axis + 1, start, n)
        if padded > n:
            part = F.pad(part, inner + [0, padded - n])
        parts.append(part.flatten(head_axis, head_axis + 1).contiguous())
    return parts


def merge_groups(outs: Sequence[torch.Tensor], hk: int, plan,
                 head_axis: int) -> torch.Tensor:
    """Inverse of :func:`split_groups` on the launches' outputs: drop each
    launch's pad rows and put the heads back in order."""
    parts = [o.unflatten(head_axis, (hk, padded)).narrow(head_axis + 1, 0, n)
             for o, (_, n, padded) in zip(outs, plan)]
    if len(parts) > 1:
        parts = [torch.cat(parts, dim=head_axis + 1)]
    return parts[0].flatten(head_axis, head_axis + 1).contiguous()
