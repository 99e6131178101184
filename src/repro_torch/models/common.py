"""Shared model components: runtime knobs, layer plans, norms, RoPE and
M-RoPE, MLP, init (counterpart of ``repro.models.common``).

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
    the JAX package).  ``mlstm_chunk`` is the chunk length of the
    chunkwise mLSTM prefill; ``moe_chunk`` > 0 runs the MoE dispatch of a
    training forward in token chunks of that size (serving never does, as
    in the JAX package).  ``remat`` recomputes each layer's activations in
    the backward pass of a training step (``torch.utils.checkpoint``);
    ``vocab_chunk`` > 0 computes the training loss over token chunks of
    that size, each chunk's logits recomputed in the backward, so the
    (tokens, V) float32 logits never exist whole.  The JAX ``Runtime``'s
    ``use_pallas``, ``q_chunk``, ``kv_chunk`` and ``causal_scheme`` choose
    among XLA and Pallas routes and are not ported: on the card the CUDA
    kernels always run.  Its ``mesh_axes``, ``use_ep_moe``, ``ep_axis``,
    ``train_style`` and ``sequence_parallel`` shape an SPMD mesh, and the
    port runs on one device."""

    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    kv_dtype: str = "bf16"            # bf16 | int8 (quantized KV cache)
    mlstm_chunk: int = 64             # chunkwise mLSTM chunk length
    moe_chunk: int = 0                # token-chunked MoE dispatch (0 = off)
    remat: bool = False               # recompute each layer in training
    vocab_chunk: int = 0              # 0 = unchunked loss; else token chunk

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


def stage_device(device: Union[str, torch.device, None]) -> torch.device:
    """``resolve_device``'s device with its index: a bare ``cuda`` is the
    current card, so ``cuda`` and ``cuda:0`` name one device wherever
    devices are compared or used as keys.  A card index at or past the
    number of visible cards raises ``ValueError``: nothing falls back to
    another device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"{dev} names card {index}, but "
                         f"{torch.cuda.device_count()} card(s) are visible")
    return torch.device("cuda", index)


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


# M-RoPE sections (rotation pairs taking their position from the t / h / w
# component), qwen2-vl style, scaled to the head's Dh / 2 pairs
MROPE_SECTIONS = (16, 24, 24)


def mrope_components(head_dim: int) -> np.ndarray:
    """(Dh/2,) the position component (0 = t, 1 = h, 2 = w) each rotation
    pair reads: contiguous sections of the frequency spectrum in the
    proportions of ``MROPE_SECTIONS``, the last taking the rounding."""
    half = head_dim // 2
    sections = np.asarray(MROPE_SECTIONS, dtype=np.int64)
    sections = (sections * half / sections.sum()).astype(np.int64)
    sections[-1] = half - sections[:-1].sum()
    return np.repeat(np.arange(3), sections)


@functools.lru_cache(maxsize=32)
def _mrope_comp(head_dim: int, device: torch.device):
    """``mrope_components`` on ``device``, uploaded once."""
    return torch.as_tensor(mrope_components(head_dim)).to(device)


def mrope_tables(positions3: torch.Tensor, head_dim: int, theta: float):
    """M-RoPE's (cos, sin), each (..., S, 1, Dh/2) float32 as
    ``rope_tables`` gives them, from ``positions3`` (3, ..., S) (t, h, w):
    pair ``i`` rotates by ``positions3[comp_i] * freq_i``.  With equal
    components (text) this is ``rope_tables`` at scaling 1 exactly."""
    freqs = _rope_freqs(head_dim, theta, positions3.device)
    pos = positions3.float().index_select(0, _mrope_comp(head_dim,
                                                         positions3.device))
    angles = pos.movedim(0, -1) * freqs                     # (..., S, Dh/2)
    angles = angles[..., None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                theta: float) -> torch.Tensor:
    """Multimodal RoPE.  x (..., S, H, Dh); positions3 (3, ..., S)."""
    return rotate(x, *mrope_tables(positions3, x.shape[-1], theta))


def text_positions3(positions: torch.Tensor) -> torch.Tensor:
    """Text tokens use identical (t, h, w) components: (3, ..., S)."""
    return positions[None].expand((3,) + tuple(positions.shape))


def patch_positions3(batch: int, n_patches: int, device=None) -> torch.Tensor:
    """A square patch grid at t = 0 with (h, w) raster positions:
    (3, B, P)."""
    side = max(1, int(np.sqrt(n_patches)))
    idx = torch.arange(n_patches, device=device)
    p3 = torch.stack([torch.zeros_like(idx), idx // side, idx % side])
    return p3[:, None, :].expand(3, batch, n_patches)


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

def dense_init(gen: Optional[torch.Generator], shape: tuple,
               dtype: torch.dtype, device: torch.device,
               fan_in: Optional[int] = None):
    """normal x 1/sqrt(fan_in), drawn in float32 and cast — the recipe of
    ``repro.models.common.dense_init``.  Only this one tensor's float32
    copy is alive at a time.  On the meta device it draws nothing (``gen``
    may be None): an empty tensor of the shape and dtype."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)
