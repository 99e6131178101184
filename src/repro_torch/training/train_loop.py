"""The training step and loop (counterpart of ``repro.training.train_loop``):
gradient accumulation, layer recomputation (``Runtime.remat``), and an
optional gradient compressor before the optimizer (DeServe is an inference
paper, but its decentralised substrate wants cheap data-parallel training;
``distributed.compression``).

The loop runs eagerly on the parameters' device: the JAX package's ``jit``
and buffer donation have no counterpart (a step drops its references to
the old parameters and moments when it returns the new ones).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.models.common import Runtime
from repro_torch.training import optimizer as opt_lib
from repro_torch.tree import leaves, unflatten_like


def _to_device(batch: dict, device) -> dict:
    """A data batch (numpy arrays or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _value_and_grad(params, batch: dict, cfg: ModelConfig, rt: Runtime):
    """(loss, gradient tree like ``params``): a parameter that the batch
    does not reach (a front end's projection when its input is absent)
    gets zeros, as ``jax.grad`` gives it."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss = model_lib.train_loss(unflatten_like(params, flat), batch, cfg, rt)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), unflatten_like(params, grads)


def make_train_step(cfg: ModelConfig, rt: Runtime, ocfg: opt_lib.AdamWConfig,
                    *, accum_steps: int = 1, compressor=None) -> Callable:
    """The train step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``.

    With ``accum_steps`` > 1 every batch leaf carries a leading
    accumulation axis (tokens (A, B, S) etc.): the loss and the float32
    gradients are summed over the A microbatches and divided by A.
    ``compressor`` (optional) is applied to the gradients before the
    optimizer: its decompressed output is what the optimizer consumes
    (error feedback lives inside the compressor).  ``metrics`` holds
    ``"loss"``, ``"lr"`` and ``"grad_norm"`` as tensors."""

    def train_step(params, opt_state, batch):
        device = leaves(params)[0].device
        batch = _to_device(batch, device)
        if accum_steps == 1:
            loss, grads = _value_and_grad(params, batch, cfg, rt)
        else:
            loss, acc = 0.0, None
            for a in range(accum_steps):
                mb_loss, mb_grads = _value_and_grad(
                    params, {k: v[a] for k, v in batch.items()}, cfg, rt)
                loss = loss + mb_loss
                mb = [g.float() for g in leaves(mb_grads)]
                acc = mb if acc is None else [x + y for x, y in zip(acc, mb)]
            loss = loss / accum_steps
            grads = unflatten_like(params, [g / accum_steps for g in acc])
        if compressor is not None:
            grads = compressor.roundtrip(grads)
        params, opt_state, metrics = opt_lib.apply(ocfg, params, grads,
                                                   opt_state)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


@dataclass
class TrainResult:
    losses: list
    steps: int
    tokens: int
    seconds: float

    @property
    def tokens_per_second(self) -> float:
        return self.tokens / max(self.seconds, 1e-9)


def train(cfg: ModelConfig, rt: Runtime, ocfg: opt_lib.AdamWConfig,
          data_iter, *, steps: int, params=None, opt_state=None,
          accum_steps: int = 1, compressor=None, checkpoint_mgr=None,
          checkpoint_every: int = 0, log_every: int = 0,
          device=None) -> tuple:
    """Run ``steps`` training steps from ``opt_state``'s step on.

    ``params`` default to ``models.model.init_params(cfg, 0, rt, device)``
    (seed 0, as the JAX loop's ``PRNGKey(0)``; ``device`` is ``cuda``
    unless asked); batches from ``data_iter`` (numpy dicts,
    ``data.pipeline.batches``) go to the parameters' device.  Each step's
    loss is read back to the host (one synchronisation a step, as the JAX
    loop's ``float(metrics["loss"])``).  Every ``checkpoint_every`` steps
    ``checkpoint_mgr`` saves ``{"params", "opt_state"}``.

    Returns (params, opt_state, TrainResult)."""
    if params is None:
        params = model_lib.init_params(cfg, 0, rt, device)
    if opt_state is None:
        opt_state = opt_lib.init(ocfg, params)
    step_fn = make_train_step(cfg, rt, ocfg, accum_steps=accum_steps,
                              compressor=compressor)
    losses = []
    tokens = 0
    t0 = time.perf_counter()
    start = int(opt_state.step)
    for i in range(start, start + steps):
        batch = next(data_iter)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        tokens += int(np.asarray(batch["tokens"]).size) \
            if "tokens" in batch else 0
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i+1}: loss={loss:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f}")
        if checkpoint_mgr is not None and checkpoint_every and \
                (i + 1) % checkpoint_every == 0:
            checkpoint_mgr.save(i + 1, {"params": params,
                                        "opt_state": opt_state})
    dt = time.perf_counter() - t0
    return params, opt_state, TrainResult(losses=losses, steps=steps,
                                          tokens=tokens, seconds=dt)
