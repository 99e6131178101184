"""Carry the JAX package's parameters into the port.

``from_jax_params`` takes the tree ``repro.models.model.init_params`` makes,
already turned into numpy (``jax.tree.map(np.asarray, params)``), and
returns the port's per-layer dict (``models.model``).  The JAX tree keeps
``"scan"`` leaves stacked over pattern periods (leading axis
``n_periods``) and the remainder layers under ``"tail"``; layer order is
period by period, then the tail.  Weights keep their ``(in, out)`` layout.
Every leaf is cast to ``rt.param_dtype`` except an ``"rglru"`` layer's
gate biases and Lambda (``model.FLOAT32_LEAVES``), which the JAX package
keeps in float32 whatever the parameter dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.common import DEFAULT_RUNTIME, Runtime, \
    make_layer_plan, resolve_device
from repro_torch.models.model import FLOAT32_LEAVES, check_supported


def from_jax_params(np_tree: dict, cfg: ModelConfig,
                    rt: Runtime = DEFAULT_RUNTIME, device=None) -> dict:
    """The port's parameters on ``device`` (``cuda`` unless asked)."""
    check_supported(cfg)
    device = resolve_device(device)
    plan = make_layer_plan(cfg.num_layers, cfg.block_pattern)

    def t(a, dtype=rt.param_dtype) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype)

    def layer(d: dict) -> dict:
        return {k: t(a, torch.float32 if k in FLOAT32_LEAVES else
                     rt.param_dtype) for k, a in d.items()}

    layers = []
    for p in range(plan.n_periods):
        for pos in range(len(plan.period_kinds)):
            layers.append(layer({k: a[p] for k, a in
                                 np_tree["scan"][pos].items()}))
    layers.extend(layer(d) for d in np_tree["tail"])
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{cfg.name}: the tree holds {len(layers)} layers, "
                         f"the config {cfg.num_layers}")
    return {"embed": {k: t(a) for k, a in np_tree["embed"].items()},
            "final_norm": t(np_tree["final_norm"]),
            "layers": layers}
