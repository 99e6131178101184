"""AdamW and its learning-rate schedules over the port's parameter trees
(counterpart of ``repro.training.optimizer``).

Parameters, gradients and moments are trees of tensors (``repro_torch.
tree``): the model's parameter dict.  ``apply`` is functional, as in the
JAX package: it returns new tensors and leaves its inputs alone.
``apply_`` is the same update written into the tensors it is given, the
counterpart of the JAX loop's buffer donation: the training loop's
captured step keeps its weights and moments at fixed addresses, and no
second copy of them exists while it runs.  The moments are kept in
``moment_dtype`` (float32 by default) and the arithmetic is float32
whatever the parameter dtype.
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


def _clip_scale(max_norm: float, norm: torch.Tensor) -> torch.Tensor:
    """The clip's factor ``min(1, max_norm / norm)``."""
    return (max_norm / norm.clamp(min=1e-12)).clamp(max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by ``min(1, max_norm / norm)``, the norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(max_norm, norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _factors(cfg: AdamWConfig, step: torch.Tensor) -> tuple:
    """(lr, c1, c2) at the new ``step``: the learning rate and the two
    bias corrections."""
    return (schedule_lr(cfg, step), 1.0 - cfg.beta1 ** step.float(),
            1.0 - cfg.beta2 ** step.float())


def _update(cfg: AdamWConfig, p, g, m, v, lr, c1, c2) -> tuple:
    """One leaf's AdamW update: (new p, new m, new v) in their dtypes."""
    b1, b2 = cfg.beta1, cfg.beta2
    gf = g.float()
    m_new = b1 * m.float() + (1 - b1) * gf
    v_new = b2 * v.float() + (1 - b2) * gf * gf
    delta = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
    pf = p.float()
    pf = pf - lr * (delta + cfg.weight_decay * pf)
    return (pf.to(p.dtype), m_new.to(cfg.moment_dtype),
            v_new.to(cfg.moment_dtype))


def apply(cfg: AdamWConfig, params, grads, state: AdamWState) -> tuple:
    """One AdamW update.  Returns (new_params, new_state, metrics) with
    metrics ``{"lr", "grad_norm"}`` (the norm before clipping), tensors on
    the parameters' device."""
    gnorm = global_norm(grads)
    if cfg.grad_clip > 0:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr, c1, c2 = _factors(cfg, step)
    out = [_update(cfg, *t, lr, c1, c2)
           for t in zip(leaves(params), leaves(grads), leaves(state.m),
                        leaves(state.v))]
    new_p, new_m, new_v = (unflatten_like(params, [o[i] for o in out])
                           for i in range(3))
    return new_p, AdamWState(step, new_m, new_v), {
        "lr": lr, "grad_norm": gnorm}


def apply_(cfg: AdamWConfig, params, grads, state: AdamWState) -> tuple:
    """:func:`apply` in place: the new parameters, moments and step are
    written into ``params`` and ``state``'s own tensors, bit for bit what
    ``apply`` returns, one leaf at a time (the clip too, so no second copy
    of the gradients, weights or moments is made).  Returns ``(lr,
    grad_norm)``, as ``apply``'s metrics."""
    gnorm = global_norm(grads)
    scale = _clip_scale(cfg.grad_clip, gnorm) if cfg.grad_clip > 0 \
        else None
    state.step.add_(1)
    lr, c1, c2 = _factors(cfg, state.step)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        if scale is not None:
            g = (g.float() * scale).to(g.dtype)
        new = _update(cfg, p, g, m, v, lr, c1, c2)
        for t, n in zip((p, m, v), new):
            t.copy_(n)
    return lr, gnorm
