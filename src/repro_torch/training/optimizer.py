"""AdamW and its learning-rate schedules over the port's parameter trees
(counterpart of ``repro.training.optimizer``).

Parameters, gradients and moments are trees of tensors (``repro_torch.
tree``): the model's parameter dict.  The update is functional, as in the
JAX package: ``apply`` returns new tensors and leaves its inputs alone.
The moments are kept in ``moment_dtype`` (float32 by default) and the
arithmetic is float32 whatever the parameter dtype.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten_like


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0            # global-norm clip; 0 disables
    moment_dtype: Any = torch.float32
    schedule: str = "cosine"          # cosine | constant | linear
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor                # int32 scalar, on the parameters' device
    m: Any                            # tree like the parameters
    v: Any


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor): a
    linear warmup over ``warmup_steps``, then constant, linear or cosine
    decay to ``min_lr_ratio`` of ``lr`` at ``total_steps``; float32."""
    step_f = torch.as_tensor(step).float()
    warm = (step_f / max(cfg.warmup_steps, 1)).clamp(max=1.0)
    span = max(cfg.total_steps - cfg.warmup_steps, 1)
    if cfg.schedule == "constant":
        decay = torch.ones_like(step_f)
    elif cfg.schedule == "linear":
        frac = ((step_f - cfg.warmup_steps) / span).clamp(0.0, 1.0)
        decay = 1.0 - (1.0 - cfg.min_lr_ratio) * frac
    else:                             # cosine
        frac = ((step_f - cfg.warmup_steps) / span).clamp(0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def init(cfg: AdamWConfig, params) -> AdamWState:
    """Zero moments like ``params`` and step 0, on the parameters' device."""
    device = leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                  device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    return torch.sqrt(sum(l.float().square().sum() for l in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by ``min(1, max_norm / norm)``, the norm)."""
    norm = global_norm(grads)
    scale = (max_norm / norm.clamp(min=1e-12)).clamp(max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def apply(cfg: AdamWConfig, params, grads, state: AdamWState) -> tuple:
    """One AdamW update.  Returns (new_params, new_state, metrics) with
    metrics ``{"lr", "grad_norm"}`` (the norm before clipping), tensors on
    the parameters' device."""
    gnorm = global_norm(grads)
    if cfg.grad_clip > 0:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        pf = p.float()
        pf = pf - lr * (delta + cfg.weight_decay * pf)
        return (pf.to(p.dtype), m_new.to(cfg.moment_dtype),
                v_new.to(cfg.moment_dtype))

    out = [upd(*t) for t in zip(leaves(params), leaves(grads),
                                leaves(state.m), leaves(state.v))]
    new_p, new_m, new_v = (unflatten_like(params, [o[i] for o in out])
                           for i in range(3))
    return new_p, AdamWState(step, new_m, new_v), {
        "lr": lr, "grad_norm": gnorm}
