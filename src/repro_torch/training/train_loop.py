"""The training step and loop (counterpart of ``repro.training.train_loop``):
gradient accumulation, layer recomputation (``Runtime.remat``), and an
optional gradient compressor before the optimizer (DeServe is an inference
paper, but its decentralised substrate wants cheap data-parallel training;
``distributed.compression``).

``make_train_step`` is the functional step, as the JAX package writes
it.  ``train`` runs its counterpart of ``jax.jit(step_fn,
donate_argnums=(0, 1))``: one static-buffer step that reads the batch
from static tensors, updates the weights, the moments, the step and the
compressor's residual in place (``optimizer.apply_``, the donation) and
writes the loss, the learning rate and the gradient norm into static
outputs.  On a card that step is a CUDA graph (``serving.step_graph``,
key ``("train", batch shapes, accum_steps)``): the first step runs
eagerly and is step 1's result, the second is captured and replayed,
every later one replays.  On the CPU the same step runs eagerly.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.models.common import Runtime
from repro_torch.serving.step_graph import StepGraphs
from repro_torch.training import optimizer as opt_lib
from repro_torch.tree import leaves, tree_map, unflatten_like


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


def _loss_and_grads(params, batch: dict, cfg: ModelConfig, rt: Runtime,
                    accum_steps: int):
    """(loss, gradients) of a batch on the parameters' device; with
    ``accum_steps`` > 1 the mean over the batch's leading axis of float32
    gradients (``make_train_step``)."""
    if accum_steps == 1:
        return _value_and_grad(params, batch, cfg, rt)
    loss, acc = 0.0, None
    for a in range(accum_steps):
        mb_loss, mb_grads = _value_and_grad(
            params, {k: v[a] for k, v in batch.items()}, cfg, rt)
        loss = loss + mb_loss
        mb = [g.float() for g in leaves(mb_grads)]
        acc = mb if acc is None else [x + y for x, y in zip(acc, mb)]
    return loss / accum_steps, unflatten_like(
        params, [g / accum_steps for g in acc])


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
        loss, grads = _loss_and_grads(params, batch, cfg, rt, accum_steps)
        if compressor is not None:
            grads = compressor.roundtrip(grads)
        params, opt_state, metrics = opt_lib.apply(ocfg, params, grads,
                                                   opt_state)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def _static_step(params, opt_state: opt_lib.AdamWState, batch: dict,
                 metrics: dict, *, cfg: ModelConfig, rt: Runtime,
                 ocfg: opt_lib.AdamWConfig, accum_steps: int,
                 compressor) -> None:
    """``make_train_step``'s step over static tensors: the batch read from
    ``batch``, the weights, moments, step and residual updated in place,
    the loss, learning rate and gradient norm written into ``metrics``
    (float32 scalars)."""
    loss, grads = _loss_and_grads(params, batch, cfg, rt, accum_steps)
    if compressor is not None:
        grads = compressor.roundtrip(grads)
    lr, gnorm = opt_lib.apply_(ocfg, params, grads, opt_state)
    for name, value in (("loss", loss), ("lr", lr), ("grad_norm", gnorm)):
        metrics[name].copy_(value)


def _state_leaves(params, opt_state: opt_lib.AdamWState,
                  compressor) -> list:
    """Every tensor a step updates in place (for a stand-in capture that
    runs the step: ``StepGraphs.capture_runs_step``)."""
    rows = leaves(params) + [opt_state.step] + leaves(opt_state.m) + \
        leaves(opt_state.v)
    if compressor is not None and compressor._residual is not None:
        rows += leaves(compressor._residual)
    return rows


@dataclass
class TrainResult:
    losses: list
    steps: int
    tokens: int
    seconds: float
    graphs: Optional[dict] = None     # the step's StepGraphs.stats()
    step_seconds: Optional[list] = None   # host seconds of each step

    @property
    def tokens_per_second(self) -> float:
        return self.tokens / max(self.seconds, 1e-9)


def train(cfg: ModelConfig, rt: Runtime, ocfg: opt_lib.AdamWConfig,
          data_iter, *, steps: int, params=None, opt_state=None,
          accum_steps: int = 1, compressor=None, donate: bool = True,
          checkpoint_mgr=None, checkpoint_every: int = 0,
          log_every: int = 0, device=None) -> tuple:
    """Run ``steps`` training steps from ``opt_state``'s step on.

    ``params`` default to ``models.model.init_params(cfg, 0, rt, device)``
    (seed 0, as the JAX loop's ``PRNGKey(0)``; ``device`` is ``cuda``
    unless asked); batches from ``data_iter`` (numpy dicts,
    ``data.pipeline.batches``) are copied into the step's static tensors
    on the parameters' device.  With ``donate`` (the JAX loop's default)
    the caller's weight and moment tensors are updated in place, as JAX
    gives up donated buffers; without it the loop works on copies and the
    caller's stay as they were.  The compressor's residual is allocated
    before the first step (``Compressor.prime``) and updated in place, so
    error feedback runs across steps.  Each step's loss is read back to
    the host (one synchronisation a step, as the JAX loop's
    ``float(metrics["loss"])``).  Every ``checkpoint_every`` steps
    ``checkpoint_mgr`` saves ``{"params", "opt_state"}``, the live
    tensors.  The steps' graphs are dropped when the call returns (a
    fresh call captures anew).

    Returns (params, opt_state, TrainResult)."""
    if params is None:
        params = model_lib.init_params(cfg, 0, rt, device)
    if opt_state is None:
        opt_state = opt_lib.init(ocfg, params)
    if not donate:
        params = tree_map(torch.clone, params)
        opt_state = tree_map(torch.clone, opt_state)
    if compressor is not None:
        compressor.prime(params)
    device = leaves(params)[0].device
    metrics = {name: torch.zeros((), dtype=torch.float32, device=device)
               for name in ("loss", "lr", "grad_norm")}
    statics: dict = {}                  # key -> the batch's static tensors
    graphs = StepGraphs(release_cache=True)
    state = partial(_state_leaves, params, opt_state, compressor)
    losses, step_seconds = [], []
    tokens = 0
    t0 = time.perf_counter()
    start = int(opt_state.step)
    for i in range(start, start + steps):
        t_step = time.perf_counter()
        batch = {k: torch.as_tensor(v) for k, v in next(data_iter).items()}
        # the key: the batch's names, shapes and dtypes, the accumulation
        key = ("train", tuple((k, tuple(v.shape), v.dtype)
                              for k, v in sorted(batch.items())),
               accum_steps)
        if key not in statics:
            statics[key] = {k: torch.empty(v.shape, dtype=v.dtype,
                                           device=device)
                            for k, v in batch.items()}
        for k, v in batch.items():
            statics[key][k].copy_(v)
        graphs.run(key, device, partial(
            _static_step, params, opt_state, statics[key], metrics, cfg=cfg,
            rt=rt, ocfg=ocfg, accum_steps=accum_steps,
            compressor=compressor), state=state, defer=True)
        loss = float(metrics["loss"])
        step_seconds.append(time.perf_counter() - t_step)
        losses.append(loss)
        tokens += batch["tokens"].numel() if "tokens" in batch else 0
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i+1}: loss={loss:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f}")
        if checkpoint_mgr is not None and checkpoint_every and \
                (i + 1) % checkpoint_every == 0:
            checkpoint_mgr.save(i + 1, {"params": params,
                                        "opt_state": opt_state})
    dt = time.perf_counter() - t0
    stats = graphs.stats()
    graphs.clear()
    return params, opt_state, TrainResult(losses=losses, steps=steps,
                                          tokens=tokens, seconds=dt,
                                          graphs=stats,
                                          step_seconds=step_seconds)
