"""Shared model components: runtime knobs, layer plans, norms, RoPE, MLP,
init (counterpart of ``repro.models.common``).

Functions take and return ``torch.Tensor``s and keep the JAX package's
layouts at their boundaries (activations ``(..., S, H, Dh)``, weights
``(in, out)``), so the parity tests compare like with like.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch


@dataclass(frozen=True)
class Runtime:
    """Execution dtypes.  Parameters and activations default to bf16, the
    dtype of the main path on the card; the CPU tests use float32.
    ``kv_dtype="int8"`` stores the dense and ring caches as int8 with bf16
    per-(token, head) scales (the paged pools keep ``compute_dtype``, as in
    the JAX package).  The JAX ``Runtime``'s ``use_pallas``, ``q_chunk``,
    ``kv_chunk`` and ``causal_scheme`` choose among XLA and Pallas routes
    and are not ported: on the card the CUDA kernels always run."""

    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    kv_dtype: str = "bf16"            # bf16 | int8 (quantized KV cache)

    def __post_init__(self):
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8', "
                             f"got {self.kv_dtype!r}")


DEFAULT_RUNTIME = Runtime()


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  With no GPU and no explicit request this raises — the
    port never quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Layer plan: scan periods + tail (the JAX package's parameter layout)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerPlan:
    period_kinds: tuple     # kinds within one period
    n_periods: int          # number of scanned periods
    tail_kinds: tuple       # remainder layers


def make_layer_plan(num_layers: int, pattern: tuple) -> LayerPlan:
    period = len(pattern)
    n_periods = num_layers // period
    tail = tuple(pattern[: num_layers % period])
    if n_periods == 0:
        return LayerPlan(period_kinds=(), n_periods=0, tail_kinds=tail)
    return LayerPlan(period_kinds=tuple(pattern), n_periods=n_periods,
                     tail_kinds=tail)


# ---------------------------------------------------------------------------
# Basic ops
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm that scales by ``1 + w`` (weights are zero-initialised), as
    the JAX package does — not ``torch.nn.RMSNorm``'s ``w``."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + weight.float())).to(dtype)


def swiglu(x, wg, wu, wd):
    g = x @ wg
    u = x @ wu
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return h @ wd


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


@functools.lru_cache(maxsize=32)
def _rope_freqs(head_dim: int, theta: float, device: torch.device):
    """The float32 frequency table on ``device``, uploaded once: a fresh
    host-to-device copy per layer call would synchronise the stream."""
    return torch.as_tensor(rope_frequencies(head_dim, theta),
                           dtype=torch.float32).to(device)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                scaling: float = 1.0):
    """(cos, sin) of the rotation angles, each (..., S, 1, Dh/2) float32.
    They depend on the positions only, so a step computes them once for
    every layer."""
    freqs = _rope_freqs(head_dim, theta, positions.device)
    angles = positions.float()[..., None] * freqs / scaling     # (..., S, Dh/2)
    angles = angles[..., None, :]                               # (..., S, 1, Dh/2)
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotary embedding over split halves (not interleaved pairs)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rotate_qk(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor):
    """``rotate`` of q (..., S, H, Dh) and k (..., S, Hk, Dh) in one pass
    over their heads side by side: the same elementwise arithmetic as two
    calls, with one set of launches instead of two (an eager decode step
    is bound by the host's launches).  Both come back contiguous."""
    h = q.shape[-2]
    qk = rotate(torch.cat([q, k], dim=-2), cos, sin)
    return qk[..., :h, :].contiguous(), qk[..., h:, :].contiguous()


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               scaling: float = 1.0) -> torch.Tensor:
    """Rotary embedding.  x (..., S, H, Dh); positions (..., S) integers."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta, scaling))


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: tuple, dtype: torch.dtype,
               device: torch.device, fan_in: Optional[int] = None):
    """normal x 1/sqrt(fan_in), drawn in float32 and cast — the recipe of
    ``repro.models.common.dense_init``.  Only this one tensor's float32
    copy is alive at a time."""
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)
