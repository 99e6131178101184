"""The decoder: weights, the training loss, chunked and exact-length
prefill, decode (counterpart of ``repro.models.model``; every layer kind:
the attention kinds, the Griffin recurrent kind ``"rglru"`` and the xLSTM
kinds ``"mlstm"`` and ``"slstm"``; every front end: tokens, audio frames,
vision patches ahead of text with M-RoPE).

Parameters are a plain dict of tensors, one entry per layer, with the JAX
package's ``(in, out)`` weight layout::

    {"embed": {"tok": (V, D), "untok": (V, D)}, "final_norm": (D,),
     "layers": [{"ln1", "wq", "wk", "wv", "wo", "ln2", "wg", "wu", "wd"}]}

(``"untok"`` is absent with tied embeddings; ``"embed"`` also holds
``"frame_proj"`` or ``"patch_proj"`` (D, D) for an audio or vision front
end; ``"q_norm"``/``"k_norm"``
join a layer with qk-norm; with ``cfg.moe`` an attention layer's FFN is
``"ln2"`` and ``"moe": {"router" (D, E), "wg", "wu" (E, D, d_expert),
"wd" (E, d_expert, D)}``.)  An ``"rglru"`` layer holds ``"ln1", "wg",
"wx", "conv_w", "conv_b", "gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b",
"lam", "wo"`` and its MLP under ``"ln2", "wg_mlp", "wu", "wd"``; an
``"mlstm"`` layer ``"ln1", "wm", "wz", "wq", "wk", "wv" (H, dh, dh),
"w_i", "b_i", "w_f", "b_f", "wo"``; an ``"slstm"`` layer ``"ln1", "w_in"
(4, D, Dr), "b_in" (4, Dr), "r" (4, H, dh, dh), "wo"``.  The router, the
RG-LRU gate biases and Lambda, the mLSTM gate weights and biases and the
sLSTM input bias are float32 whatever ``param_dtype`` is
(``FLOAT32_LEAVES``).  Caches hold one entry per layer::

    {"layers": [...], "page_table": (B, max_pages) int32}

where a layer's entry is either a paged pool shared by every row
(``"attn"``/``"global"`` in the serving engine, ``serving.kv_cache``)::

    {"k_pages": (P, page, Hk, Dh), "v_pages": ...}

or a per-row dense cache, a ring of ``window`` slots for ``"local"``
layers (``init_caches``, ``_kind_cache``)::

    {"k": (B, C, Hk, Dh), "v": ..., "pos": (B, C) int32 (-1 empty)}
    (+ "k_scale", "v_scale": (B, C, Hk) bf16 when ``Runtime.kv_dtype`` is
    "int8", with int8 "k"/"v")

or a recurrent state a row::

    "rglru": {"h": (B, Dr) float32, "conv": (B, cw-1, Dr) compute dtype}
    "mlstm": {"c": (B, H, dh, dh), "n": (B, H, dh), "m": (B, H)} float32
    "slstm": {"c", "n", "h", "m": (B, Dr)} float32

and one page table shared by every paged layer (absent when no layer is
paged).  Pools, rings and recurrent states are updated **in place**
(``index_put_``, slice assignment, ``copy_``): a full-width pool is
gigabytes, and a functional copy per layer per step would double it; and
the serving backend hands the model a row *view* of its caches
(``serving.kv_cache.slot_view``), through which only in-place writes
reach the batch-wide tensors.  ``run_layers`` is a loop over layers, or
over one contiguous range of them (a pipeline stage, ``core.pipeline``).
A training forward (``mode="train"``, ``train_loss``) keeps no cache and
writes nothing in place; its attention and scan run through the kernels'
autograd wrappers (``kernels.ops``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ATTN_KINDS, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_lib
from repro_torch.models import embedding as embed_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.common import (DEFAULT_RUNTIME, Runtime, dense_init,
                                       mrope_tables, patch_positions3,
                                       resolve_device, rms_norm, rope_tables,
                                       rotate_qk, swiglu, text_positions3)

PAGED_KINDS = ("attn", "global")
LOCAL_ROPE_THETA = 10000.0      # gemma3: local layers keep the small base
# the leaves of each kind that stay float32 whatever param_dtype is (an
# attention layer's under its nested "moe")
FLOAT32_LEAVES = {
    **{kind: ("router",) for kind in ATTN_KINDS},
    "rglru": ("gate_a_b", "gate_x_b", "lam"),
    "mlstm": ("w_i", "b_i", "w_f", "b_f"),
    "slstm": ("b_in",),
}


def layer_theta(kind: str, cfg: ModelConfig) -> float:
    """RoPE base of a layer: gemma3's sliding-window layers keep 10k."""
    if kind == "local" and cfg.window_size:
        return LOCAL_ROPE_THETA
    return cfg.rope_theta


# ---------------------------------------------------------------------------
# Parameter init (on the device, tensor by tensor)
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int, rt: Runtime = DEFAULT_RUNTIME,
                device=None, layer_devices=None) -> dict:
    """Random weights from ``seed`` with ``repro.models.common.dense_init``'s
    recipe (normal x 1/sqrt(fan_in), zero norm weights), made on ``device``
    (``cuda`` unless asked, see ``resolve_device``) one tensor at a time in
    ``rt.param_dtype``.  The numbers differ from the JAX package's (another
    generator); tests that compare the two convert the JAX weights instead
    (``models.convert``).  On the meta device (the dry run's stand-ins)
    every leaf has its shape and dtype and nothing is drawn.

    ``layer_devices`` (one device a layer, ``core.pipeline.layer_devices``)
    places the weights by pipeline stage, as :func:`place_params` lays them
    out.  Every tensor is still drawn on ``device`` (``layer_devices[0]``
    when not given) from the one generator, in the same order, and each
    layer moves to its device as soon as it is made: the weights equal a
    one-device init's bit for bit, and no device holds more than its share
    and one layer.  A tied head's table stays ``embed["tok"]`` on the first
    device (:func:`tied_head` copies it where the head is)."""
    if layer_devices is not None and device is None:
        device = layer_devices[0]
    device = resolve_device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    pd = rt.param_dtype
    D, F = cfg.d_model, cfg.d_ff
    H, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    last = device if layer_devices is None else layer_devices[-1]

    def dense(shape, fan_in=None, dtype=pd):
        return dense_init(gen, shape, dtype, device, fan_in)

    def zeros(n):
        return torch.zeros((n,), dtype=pd, device=device)

    embed = {"tok": dense((cfg.vocab_size, D), fan_in=D)}
    if cfg.frontend == "audio_frames":
        embed["frame_proj"] = dense((D, D))
    elif cfg.frontend == "vision_patches":
        embed["patch_proj"] = dense((D, D))
    if not cfg.tie_embeddings:
        embed["untok"] = dense((cfg.vocab_size, D), fan_in=D).to(last)
    layers = []
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind in _RECURRENT_INIT:
            w = _RECURRENT_INIT[kind](cfg, dense, zeros, device)
        else:
            w = {"ln1": zeros(D), "wq": dense((D, H * Dh)),
                 "wk": dense((D, Hk * Dh)), "wv": dense((D, Hk * Dh)),
                 "wo": dense((H * Dh, D), fan_in=H * Dh)}
            if cfg.use_qk_norm:
                w["q_norm"], w["k_norm"] = zeros(Dh), zeros(Dh)
            if cfg.moe is not None:
                E, dE = cfg.moe.num_experts, cfg.moe.d_expert
                w["ln2"] = zeros(D)
                w["moe"] = {"router": dense((D, E), dtype=torch.float32),
                            "wg": dense((E, D, dE), fan_in=D),
                            "wu": dense((E, D, dE), fan_in=D),
                            "wd": dense((E, dE, D), fan_in=dE)}
            elif F > 0:
                w.update(ln2=zeros(D), wg=dense((D, F)), wu=dense((D, F)),
                         wd=dense((F, D), fan_in=F))
        if layer_devices is not None:
            w = _tree_to(w, layer_devices[i])
        layers.append(w)
    return {"embed": embed, "final_norm": zeros(D).to(last),
            "layers": layers}


def _to(t: torch.Tensor, device: torch.device, on_move=None) -> torch.Tensor:
    """``t`` on ``device`` (itself when it is there); ``on_move(t)`` is
    called when it moves."""
    if on_move is not None and t.device != device:
        on_move(t)
    return t.to(device)


def _tree_to(tree: dict, device: torch.device, on_move=None) -> dict:
    """A layer's weight dict (nested dicts included) with every tensor on
    ``device`` (``_to``)."""
    return {name: _tree_to(t, device, on_move) if isinstance(t, dict)
            else _to(t, device, on_move) for name, t in tree.items()}


def place_params(params: dict, layer_devices) -> int:
    """Place the weights by pipeline stage, in place: layer ``i`` on
    ``layer_devices[i]`` (``core.pipeline.layer_devices``: each stage's
    layers on its device, the epilogue's on the last stage's), the
    embedding on ``layer_devices[0]`` (stage 0 embeds; a tied head reads
    it through :func:`tied_head`), and the head (the final norm and an
    untied unembedding) on ``layer_devices[-1]``.  A layer that moves is
    replaced in ``params["layers"]`` one at a time, so its old tensors can
    be freed before the next moves (no device holds two copies of the
    model).  Tensors already in place are not touched.  Returns the bytes
    moved.

    ``layer_devices`` must carry each card's index (``cuda:0``, not
    ``cuda``; ``models.common.stage_device``)."""
    moved = [0]

    def count(t: torch.Tensor) -> None:
        moved[0] += t.numel() * t.element_size()

    first, last = layer_devices[0], layer_devices[-1]
    emb = params["embed"]
    for name in emb:
        emb[name] = _to(emb[name], last if name == "untok" else first, count)
    params["final_norm"] = _to(params["final_norm"], last, count)
    for i, dev in enumerate(layer_devices):
        params["layers"][i] = _tree_to(params["layers"][i], dev, count)
    return moved[0]


def tied_head(params: dict, cfg: ModelConfig,
              device) -> Optional[torch.Tensor]:
    """The head's table for a pipe whose last stage is on ``device``, where
    ``params`` does not hold it there: with tied embeddings and
    ``embed["tok"]`` on another device (stage 0's), a copy of it on
    ``device``; else None (``embedding.unembed`` reads ``params``).  The
    copy is the caller's, for the logits of the weights as they are now."""
    tok = params["embed"]["tok"]
    if cfg.tie_embeddings and tok.device != torch.device(device):
        return tok.to(device)
    return None


def _init_rglru_layer(cfg: ModelConfig, dense, zeros, device) -> dict:
    """``repro.models.model._init_rglru_layer``'s recipe: Lambda from
    ``a ~ U[0.9, 0.999]`` (numpy, seed 0, as the JAX package draws it) as
    ``softplus^-1(-log(a) / c)``; the gate biases and Lambda in float32."""
    D, F, Dr, H = cfg.d_model, cfg.d_ff, cfg.d_rnn, cfg.num_heads
    dh = Dr // H
    a = np.random.RandomState(0).uniform(0.9, 0.999, (Dr,))
    lam = np.log(np.expm1(-np.log(a) / rglru_lib.RGLRU_C))
    f32 = dict(dtype=torch.float32, device=device)
    w = {"ln1": zeros(D), "wg": dense((D, Dr)), "wx": dense((D, Dr)),
         "conv_w": dense((cfg.conv_width, Dr), fan_in=cfg.conv_width),
         "conv_b": zeros(Dr),
         "gate_a_w": dense((H, dh, dh), fan_in=dh),
         "gate_a_b": torch.zeros((Dr,), **f32),
         "gate_x_w": dense((H, dh, dh), fan_in=dh),
         "gate_x_b": torch.zeros((Dr,), **f32),
         "lam": torch.as_tensor(lam, dtype=torch.float32).to(device),
         "wo": dense((Dr, D), fan_in=Dr)}
    if F > 0:
        w.update(ln2=zeros(D), wg_mlp=dense((D, F)), wu=dense((D, F)),
                 wd=dense((F, D), fan_in=F))
    return w


def _init_mlstm_layer(cfg: ModelConfig, dense, zeros, device) -> dict:
    """``repro.models.model._init_mlstm_layer``'s recipe: per-head q/k/v
    of width dh = d_rnn / H, float32 gate weights and biases, and forget
    biases spread over 3..6 across the heads (start by remembering)."""
    D, Dr, H = cfg.d_model, cfg.d_rnn, cfg.num_heads
    dh = Dr // H
    f32 = torch.float32
    return {"ln1": zeros(D), "wm": dense((D, Dr)), "wz": dense((D, Dr)),
            "wq": dense((H, dh, dh), fan_in=dh),
            "wk": dense((H, dh, dh), fan_in=dh),
            "wv": dense((H, dh, dh), fan_in=dh),
            "w_i": dense((H, dh), fan_in=dh, dtype=f32),
            "b_i": torch.zeros((H,), dtype=f32, device=device),
            "w_f": dense((H, dh), fan_in=dh, dtype=f32),
            "b_f": torch.linspace(3.0, 6.0, H, dtype=f32, device=device),
            "wo": dense((Dr, D), fan_in=Dr)}


def _init_slstm_layer(cfg: ModelConfig, dense, zeros, device) -> dict:
    """``repro.models.model._init_slstm_layer``'s recipe: the float32
    input bias is 3 on the forget gate, 0 elsewhere."""
    D, Dr, H = cfg.d_model, cfg.d_rnn, cfg.num_heads
    dh = Dr // H
    b_in = torch.zeros((4, Dr), dtype=torch.float32, device=device)
    b_in[1] = 3.0
    return {"ln1": zeros(D), "w_in": dense((4, D, Dr), fan_in=D),
            "b_in": b_in, "r": dense((4, H, dh, dh), fan_in=dh),
            "wo": dense((Dr, D), fan_in=Dr)}


_RECURRENT_INIT = {"rglru": _init_rglru_layer, "mlstm": _init_mlstm_layer,
                   "slstm": _init_slstm_layer}


# ---------------------------------------------------------------------------
# Dense and ring caches (the JAX package's ``init_caches`` / ``_kind_cache``)
# ---------------------------------------------------------------------------


def _kind_cache(kind: str, cfg: ModelConfig, batch: int, capacity: int,
                rt: Runtime, device="cpu") -> dict:
    """A per-row cache: for an attention kind ``capacity`` slots, or a
    ring of ``window_size`` slots for ``"local"``, with int8 values and
    bf16 per-(token, head) scales when ``rt.kv_dtype == "int8"``; for
    a recurrent kind its zero state (``"rglru"``: the state and the conv's
    trailing inputs)."""
    if kind == "rglru":
        return {"h": torch.zeros((batch, cfg.d_rnn), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_rnn),
                                    dtype=rt.compute_dtype, device=device)}
    if kind == "mlstm":
        return xlstm_lib.mlstm_zero_state(
            batch, cfg.num_heads, cfg.d_rnn // cfg.num_heads, device)
    if kind == "slstm":
        return xlstm_lib.slstm_zero_state(batch, cfg.d_rnn, device)
    Hk, Dh = cfg.num_kv_heads, cfg.head_dim
    c = capacity if (kind != "local" or cfg.window_size == 0) else min(
        cfg.window_size, capacity)
    shape = (batch, c, Hk, Dh)
    pos = torch.full((batch, c), -1, dtype=torch.int32, device=device)
    if rt.kv_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.bfloat16,
                                       device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.bfloat16,
                                       device=device),
                "pos": pos}
    return {"k": torch.zeros(shape, dtype=rt.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=rt.compute_dtype, device=device),
            "pos": pos}


def init_caches(cfg: ModelConfig, batch: int, capacity: int,
                rt: Runtime = DEFAULT_RUNTIME, device=None) -> dict:
    """Dense caches for every layer (no paged pool, no page table), on
    ``device`` (``cuda`` unless asked)."""
    device = resolve_device(device)
    return {"layers": [_kind_cache(k, cfg, batch, capacity, rt, device)
                       for k in cfg.layer_kinds()]}


def _quantize_kv(x: torch.Tensor):
    """(..., Hk, Dh) -> (int8 values, bf16 per-(..., Hk) scales).  The
    scale is max|x| / 127 (floored at 1e-8), the values are rounded half to
    even, as ``jnp.round`` rounds."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp(min=1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _dequant_kv(cache: dict, dtype: torch.dtype):
    k = cache["k"]
    if k.dtype != torch.int8:
        return cache["k"], cache["v"]
    kf = k.float() * cache["k_scale"].float()[..., None]
    vf = cache["v"].float() * cache["v_scale"].float()[..., None]
    return kf.to(dtype), vf.to(dtype)


# ---------------------------------------------------------------------------
# Paged KV addressing (once per step: every layer's pool has one layout)
# ---------------------------------------------------------------------------


def _step_index(mode: str, positions: torch.Tensor, page_table: torch.Tensor,
                page_size: int) -> dict:
    """Where each token's K/V goes in the pools, and what attention reads.

    Decode: ``slot``, the current token's row in a pool viewed as
    ``(P * page, Hk, Dh)`` (``page * page_size + off``), and ``seq_lens``
    for the kernel.  Chunk and prefill: ``page``/``off``/``keep`` for
    ``_write_prefill_paged``, and a chunk's int32 positions ``q_pos`` for
    its attention.
    Positions marked ``-1`` (padding) must not touch a live page.  JAX drops
    their scatter as out of bounds; torch indexing would raise instead, and
    selecting only the valid positions would cost a device-to-host sync.
    So a pad position is sent to scratch page 0, offset 0, with ``keep``
    False."""
    pos = positions.long()
    pt = page_table.long()
    if mode == "decode":
        cur = pos[:, 0]
        page = pt.gather(1, (cur // page_size)[:, None])[:, 0]
        return {"slot": page * page_size + cur % page_size,
                "seq_lens": (cur + 1).to(torch.int32)}
    valid = pos >= 0
    p0 = pos.clamp(min=0)
    idx = {"page": torch.where(valid, pt.gather(1, p0 // page_size), 0),
           "off": torch.where(valid, p0 % page_size, 0),
           "keep": valid[..., None, None]}
    if mode == "chunk":
        idx["q_pos"] = positions.to(torch.int32)
    return idx


def _write_prefill_paged(cache: dict, k: torch.Tensor, v: torch.Tensor,
                         idx: dict) -> None:
    """Scatter a chunk's k/v (B, S, Hk, Dh) into the shared page pool, in
    place.  A pad position (``keep`` False) writes back the value already
    at scratch page 0, offset 0: the write is a no-op, and every pad
    position of the call writes the same value."""
    page, off, keep = idx["page"], idx["off"], idx["keep"]
    for name, new in (("k_pages", k), ("v_pages", v)):
        pool = cache[name]
        pool.index_put_((page, off),
                        torch.where(keep, new.to(pool.dtype), pool[page, off]))


def _write_prefill_cache(cache: dict, k: torch.Tensor, v: torch.Tensor,
                         positions: torch.Tensor, idx: dict) -> None:
    """Write a whole prefill's k/v (B, S, Hk, Dh) into a layer's cache, in
    place: the paged pool, or a dense cache / ring of C slots.

    ``S <= C``: the S tokens go to slots 0..S-1, pad positions included
    (their ``pos`` is -1, so attention never reads them).  ``S > C`` (a
    ring): the last C tokens of the sequence go to slot ``i % C`` (a
    prefill's token ``i`` sits at position ``i``); pad positions write
    nothing, as the JAX package drops their out-of-bounds scatter.

    This keeps the reference's behaviour exactly, defect included: with a
    prompt padded past the window, the last C tokens of the *padded*
    sequence hold up to C-1 pad positions, so up to that many in-window
    real tokens are never written (C = 8, padded 16, true length 13 holds
    positions [8..12] and -1 three times; 6 and 7 are lost)."""
    if "k_pages" in cache:
        _write_prefill_paged(cache, k, v, idx)
        return
    new = {"k": k, "v": v, "pos": positions.to(torch.int32)}
    if cache["k"].dtype == torch.int8:
        new["k"], new["k_scale"] = _quantize_kv(k)
        new["v"], new["v_scale"] = _quantize_kv(v)
    C = cache["k"].shape[1]
    S = k.shape[1]
    if S <= C:
        for name, t in new.items():
            cache[name][:, :S] = t
        return
    slots = torch.arange(S - C, S, device=k.device) % C
    keep = new["pos"][:, S - C:] >= 0                         # (B, C)
    for name, t in new.items():
        dst = cache[name]
        t = t[:, S - C:].to(dst.dtype)
        mask = keep.reshape(keep.shape + (1,) * (t.dim() - 2))
        dst[:, slots] = torch.where(mask, t, dst[:, slots])


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


def _attn_layer(kind: str, w: dict, x: torch.Tensor, cfg: ModelConfig,
                rt: Runtime, *, positions: torch.Tensor, mode: str,
                cache: Optional[dict],
                page_table, rope: tuple, idx) -> torch.Tensor:
    B, S = x.shape[:2]
    H, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    window = cfg.window_size if kind == "local" else 0
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    q = (h @ w["wq"]).reshape(B, S, H, Dh)
    k = (h @ w["wk"]).reshape(B, S, Hk, Dh)
    v = (h @ w["wv"]).reshape(B, S, Hk, Dh)
    if cfg.use_qk_norm:
        q = rms_norm(q, w["q_norm"], cfg.norm_eps)
        k = rms_norm(k, w["k_norm"], cfg.norm_eps)
    q, k = rotate_qk(q, k, *rope)

    if mode == "decode" and "k_pages" in cache:
        # one row a token in the flattened pool: index_copy_ costs the host
        # a fraction of an advanced-indexing index_put_, once a layer
        for name, t in (("k_pages", k), ("v_pages", v)):
            cache[name].view(-1, Hk, Dh).index_copy_(0, idx["slot"], t[:, 0])
        out = kops.paged_decode_attention(
            q[:, 0], cache["k_pages"], cache["v_pages"], page_table,
            idx["seq_lens"], window=window)[:, None]        # (B, 1, H, Dh)
    elif mode == "decode":
        # dense / ring cache: the token goes to slot cur % C of its row
        cur = positions[:, 0]
        slot = (cur % cache["k"].shape[1]).long()
        rows = torch.arange(B, device=x.device)
        new = {"k": k[:, 0], "v": v[:, 0], "pos": cur.to(torch.int32)}
        if cache["k"].dtype == torch.int8:
            new["k"], new["k_scale"] = _quantize_kv(k[:, 0])
            new["v"], new["v_scale"] = _quantize_kv(v[:, 0])
        for name, t in new.items():
            cache[name].index_put_((rows, slot), t.to(cache[name].dtype))
        kf, vf = _dequant_kv(cache, q.dtype)
        out = attn_lib.decode_attention(q[:, 0], kf, vf, cache["pos"], cur,
                                        window=window)[:, None]
    elif mode == "chunk":
        # write the chunk's KV into the pool, then attend the chunk's
        # queries against their rows' tables: the kernel reads the pool in
        # place (the plain version gathers each row's whole table)
        if "k_pages" not in cache:
            raise NotImplementedError(
                "chunked prefill supports paged attention layers only; "
                "ring (sliding-window) layers must use exact-length prefill")
        _write_prefill_paged(cache, k, v, idx)
        out = kops.paged_chunk_attention(
            q, cache["k_pages"], cache["v_pages"], page_table, idx["q_pos"],
            window=window)
    else:
        # exact-length prefill or a training forward: the whole sequence
        # through the flash kernel (its plain version on the CPU; with a
        # gradient when training), then a prefill's cache write
        out = kops.flash_attention(q, k, v, causal=True, window=window)
        if mode == "prefill":
            _write_prefill_cache(cache, k, v, positions, idx)

    x = x + out.reshape(B, S, H * Dh) @ w["wo"]
    if cfg.moe is not None:
        # every row of the call, padding and free slots included, goes
        # through the router and takes expert capacity, as in the JAX model
        h2 = rms_norm(x, w["ln2"], cfg.norm_eps).reshape(B * S, -1)
        x = x + moe_lib.moe_ffn(
            h2, w["moe"], cfg.moe,
            token_chunk=rt.moe_chunk if mode == "train" else 0
        ).reshape(x.shape)
    elif cfg.d_ff > 0:
        x = x + swiglu(rms_norm(x, w["ln2"], cfg.norm_eps), w["wg"], w["wu"],
                       w["wd"])
    return x


def _refuse_chunk(mode: str) -> None:
    if mode == "chunk":
        raise NotImplementedError(
            "chunked prefill is not supported for recurrent layers")


def _rglru_layer(w: dict, x: torch.Tensor, cfg: ModelConfig, rt: Runtime,
                 *,
                 positions: torch.Tensor, mode: str,
                 cache: dict) -> torch.Tensor:
    """A Griffin residual block: RG-LRU mixer, then the MLP.  In a prefill
    the positions marked -1 (right padding) are identity steps of the
    recurrence (``_recurrent_valid``).  The new state is copied into the
    cache's own tensors: they may be a row view of the batch-wide caches,
    and rebinding the dict entry would lose it."""
    _refuse_chunk(mode)
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    y, new = rglru_lib.rglru_block(h, w, cfg.num_heads, mode=mode,
                                   state=cache,
                                   valid=_recurrent_valid(positions, mode))
    if cache is not None:
        cache["h"].copy_(new["h"])
        cache["conv"].copy_(new["conv"])
    x = x + y
    if cfg.d_ff > 0:
        x = x + swiglu(rms_norm(x, w["ln2"], cfg.norm_eps), w["wg_mlp"],
                       w["wu"], w["wd"])
    return x


def _mlstm_layer(w: dict, x: torch.Tensor, cfg: ModelConfig, rt: Runtime,
                 *, positions: torch.Tensor, mode: str,
                 cache: dict) -> torch.Tensor:
    """An xLSTM mLSTM residual block (chunkwise prefill, exact decode
    step); the new state is copied into the cache's own tensors."""
    _refuse_chunk(mode)
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    y, new = xlstm_lib.mlstm_block(h, w, cfg.num_heads, mode=mode,
                                   state=cache, chunk=rt.mlstm_chunk,
                                   valid=_recurrent_valid(positions, mode))
    _keep_state(cache, new)
    return x + y


def _slstm_layer(w: dict, x: torch.Tensor, cfg: ModelConfig, rt: Runtime,
                 *, positions: torch.Tensor, mode: str,
                 cache: dict) -> torch.Tensor:
    """An xLSTM sLSTM residual block; the new state is copied into the
    cache's own tensors."""
    _refuse_chunk(mode)
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    y, new = xlstm_lib.slstm_block(h, w, cfg.num_heads, mode=mode,
                                   state=cache,
                                   valid=_recurrent_valid(positions, mode))
    _keep_state(cache, new)
    return x + y


def _keep_state(cache: Optional[dict], new: dict) -> None:
    """Copy a recurrent layer's new state into its cache (none in a
    training forward)."""
    if cache is not None:
        for name, t in new.items():
            cache[name].copy_(t)


_RECURRENT_APPLY = {"rglru": _rglru_layer, "mlstm": _mlstm_layer,
                    "slstm": _slstm_layer}


def _recurrent_valid(positions: torch.Tensor, mode: str):
    """Which tokens update the recurrent state: in a prefill, the positions
    not marked -1 (right padding of a bucketed prompt); decode and training
    positions are all real, so no mask."""
    return positions >= 0 if mode == "prefill" else None


def run_layers(params: dict, x: torch.Tensor, cfg: ModelConfig, rt: Runtime,
               *, mode: str, caches: Optional[dict], positions: torch.Tensor,
               layers: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Apply the layers in order, every one or only ``layers = (lo, hi)``
    (a pipeline stage: layers ``lo .. hi-1``, whose weights and caches are
    ``params["layers"][lo:hi]`` and ``caches["layers"][lo:hi]``); the caches
    change in place.  ``mode="train"`` takes no caches (None): attention
    runs whole-sequence without a cache write, the recurrent layers keep
    no state, the MoE dispatch runs in ``rt.moe_chunk`` token chunks, and
    with ``rt.remat`` each layer is a non-reentrant
    ``torch.utils.checkpoint`` (its activations recomputed in the
    backward; the JAX package checkpoints each scanned period).

    ``positions`` is (B, S), or (3, B, S) (t, h, w) on a vision arch, whose
    attention then rotates by M-RoPE; its t component is the position
    everything else reads (cache slots, validity), as in the JAX model.
    The RoPE tables (one per base the attention layers use) and the pool
    addressing depend on the positions only, so they are computed once
    here for all the layers of the call."""
    if mode not in ("decode", "chunk", "prefill", "train"):
        raise ValueError("mode must be 'decode', 'chunk', 'prefill' or "
                         f"'train', got {mode!r}")
    if (caches is None) != (mode == "train"):
        raise ValueError(f"mode {mode!r}: a training forward takes no "
                         "caches, every other mode takes them")
    lo, hi = (0, cfg.num_layers) if layers is None else layers
    kinds = cfg.layer_kinds()[lo:hi]
    ws = params["layers"][lo:hi]
    cs = [None] * len(ws) if caches is None else caches["layers"][lo:hi]
    pos = positions[0] if positions.dim() == 3 else positions
    if positions.dim() == 3 and cfg.frontend == "vision_patches":
        tables = lambda theta: mrope_tables(positions, cfg.head_dim, theta)
    else:
        tables = lambda theta: rope_tables(pos, cfg.head_dim, theta,
                                           cfg.rope_scaling)
    ropes = {theta: tables(theta) for theta in
             {layer_theta(k, cfg) for k in kinds if k in ATTN_KINDS}}
    page_table = None if caches is None else caches.get("page_table")
    paged = next((c for c in cs if c is not None and "k_pages" in c), None)
    idx = None if paged is None else _step_index(
        mode, pos, page_table, paged["k_pages"].shape[1])
    for kind, w, cache in zip(kinds, ws, cs):
        args = (kind, w, x, cfg, rt, pos, mode, cache, page_table, ropes, idx)
        if rt.remat and mode == "train":
            x = checkpoint(_layer, *args, use_reentrant=False)
        else:
            x = _layer(*args)
    return x


def _layer(kind: str, w: dict, x: torch.Tensor, cfg: ModelConfig,
           rt: Runtime, positions: torch.Tensor, mode: str,
           cache: Optional[dict], page_table, ropes: dict,
           idx) -> torch.Tensor:
    """One layer of ``run_layers``, by kind."""
    if kind in _RECURRENT_APPLY:
        return _RECURRENT_APPLY[kind](w, x, cfg, rt, positions=positions,
                                      mode=mode, cache=cache)
    return _attn_layer(kind, w, x, cfg, rt, positions=positions, mode=mode,
                       cache=cache, page_table=page_table,
                       rope=ropes[layer_theta(kind, cfg)], idx=idx)


# ---------------------------------------------------------------------------
# Inputs / embedding
# ---------------------------------------------------------------------------


def embed_inputs(params: dict, inputs: dict, cfg: ModelConfig, rt: Runtime):
    """(x (B, S, D), positions) from an input dict: ``{"tokens": (B, S)}``,
    ``{"frames": (B, S, D)}`` (audio) or ``{"tokens": (B, S_text),
    "patches": (B, P, D)}`` (vision; the patches go first).

    Positions are (B, S), or (3, B, S) (t, h, w) on a vision arch: the P
    patches share t = 0 on a square raster of side ``int(sqrt(P))``, and
    the text after them starts at t = that side, as the JAX model places
    them (``repro.models.model.embed_inputs``)."""
    cd = rt.compute_dtype
    if cfg.frontend == "audio_frames" and "frames" in inputs:
        x = embed_lib.embed_frames(params["embed"], inputs["frames"], cfg, cd)
        B, S = x.shape[:2]
        return x, torch.arange(S, device=x.device)[None].expand(B, S)
    if cfg.frontend == "vision_patches" and "patches" in inputs:
        xp = embed_lib.embed_patches(params["embed"], inputs["patches"], cfg,
                                     cd)
        xt = embed_lib.embed_tokens(params["embed"], inputs["tokens"], cfg, cd)
        B, P = xp.shape[:2]
        St = xt.shape[1]
        side = max(1, int(np.sqrt(P)))
        text = side + torch.arange(St, device=xt.device)[None].expand(B, St)
        positions = torch.cat([patch_positions3(B, P, xt.device),
                               text_positions3(text)], dim=2)
        return torch.cat([xp, xt], dim=1), positions
    tokens = inputs["tokens"]
    x = embed_lib.embed_tokens(params["embed"], tokens, cfg, cd)
    return x, token_positions(*tokens.shape, cfg, x.device)


def token_positions(B: int, S: int, cfg: ModelConfig,
                    device) -> torch.Tensor:
    """The positions of ``B`` rows of ``S`` text tokens from 0: (B, S), or
    the (3, B, S) text M-RoPE positions on a vision arch."""
    positions = torch.arange(S, device=device)[None].expand(B, S)
    if cfg.frontend == "vision_patches":
        positions = text_positions3(positions)
    return positions


def mark_padding(positions: torch.Tensor, last_index: torch.Tensor):
    """``(positions, li)``: every position past its row's ``last_index``
    (B,) marked -1 (the right padding of a bucketed prompt: its cache
    writes are dropped and the recurrences step over it), and
    ``last_index`` as (B,) int64 on the positions' device."""
    B, S = positions.shape[-2:]
    dev = positions.device
    li = last_index.to(dev).long().reshape(B)
    pad = torch.arange(S, device=dev)[None] > li[:, None]
    return torch.where(pad, -1, positions), li


def prefill_head(params: dict, x: torch.Tensor, li, cfg: ModelConfig,
                 head=None) -> torch.Tensor:
    """A prefill's logits (B, V) float32: the last layer's output (B, S,
    D) at each row's last index ``li`` (B,) int64, or at the last
    position when None, then the final norm and the unembedding (``head``
    as in :func:`decode_logits`).  No (S, V) logits are made."""
    B = x.shape[0]
    x_last = x[:, -1] if li is None else \
        x[torch.arange(B, device=x.device), li.to(x.device)]
    x_last = rms_norm(x_last, params["final_norm"], cfg.norm_eps)
    return embed_lib.unembed(params["embed"], x_last, cfg, head)


# ---------------------------------------------------------------------------
# Training loss (chunked cross-entropy)
# ---------------------------------------------------------------------------


def _ce_chunk(xc: torch.Tensor, labels_c: torch.Tensor, mask_c: torch.Tensor,
              params: dict, cfg: ModelConfig):
    """(sum of masked token NLLs, sum of the mask) over (B, c, D)
    activations: the float32 logits (softcap included), their
    log-sum-exp, and the label's logit."""
    logits = embed_lib.unembed(params["embed"], xc, cfg)        # (B, c, V)
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels_c.long()[..., None])[..., 0]
    return ((logz - ll) * mask_c).sum(), mask_c.sum()


def ce_loss(params: dict, x: torch.Tensor, labels: torch.Tensor,
            cfg: ModelConfig, rt: Runtime,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy over (B, S, D) final-norm activations, weighted
    by ``mask`` (B, S) (ones when None): sum of masked NLLs over the sum
    of the mask (floored at 1).  With ``rt.vocab_chunk`` > 0 the tokens go
    in chunks of that many positions, each a non-reentrant checkpoint, so
    only one chunk's (B, c, V) float32 logits exist at a time, in the
    forward and again in the backward (the JAX package's ``jax.checkpoint``
    per chunk of its scan)."""
    B, S, _ = x.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    mask = mask.float()
    chunk = rt.vocab_chunk
    if chunk <= 0 or S <= chunk:
        total, denom = _ce_chunk(x, labels, mask, params, cfg)
    else:
        total = denom = 0.0
        for i in range(0, S, chunk):
            t, d = checkpoint(_ce_chunk, x[:, i:i + chunk],
                              labels[:, i:i + chunk], mask[:, i:i + chunk],
                              params, cfg, use_reentrant=False)
            total, denom = total + t, denom + d
    return total / denom.clamp(min=1.0)


def train_loss(params: dict, batch: dict, cfg: ModelConfig,
               rt: Runtime = DEFAULT_RUNTIME) -> torch.Tensor:
    """The training loss of one batch: an input dict (``embed_inputs``)
    with ``"labels"`` (B, S) and optionally ``"loss_mask"`` (B, S).  On a
    vision arch the labels cover the text only, so the patch positions'
    activations are dropped before the loss."""
    x, positions = embed_inputs(params, batch, cfg, rt)
    x = run_layers(params, x, cfg, rt, mode="train", caches=None,
                   positions=positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    labels = batch["labels"]
    if x.shape[1] != labels.shape[1]:       # vision: drop patch positions
        x = x[:, x.shape[1] - labels.shape[1]:]
    return ce_loss(params, x, labels, cfg, rt, batch.get("loss_mask"))


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------


def prefill(params: dict, inputs: dict, cfg: ModelConfig,
            rt: Runtime = DEFAULT_RUNTIME, capacity: int = 0, caches=None,
            last_index=None, stages=None, head=None):
    """Exact-length prefill of whole prompts.  ``inputs`` is an input dict
    (``embed_inputs``: ``{"tokens"}``, ``{"frames"}`` or ``{"tokens",
    "patches"}``).  Returns (last_logits (B, V) float32, caches).

    ``caches`` may be pre-built (the serving engine's pools and rings,
    written in place); otherwise dense caches of ``capacity`` slots are
    made.  When the prompts are right-padded, ``last_index`` (B,) selects
    each row's true last position for the logits and marks the positions
    after it ``-1``, so the cache writes drop them.  The last position is
    taken before the final norm and the unembedding, so no (S, V) logits
    are made.

    ``stages`` walks pipeline stages instead of running every layer on the
    inputs' device: ``((lo, hi), device, caches)`` in order
    (``core.pipeline.stage_ranges``' ranges, the epilogue's last), each
    range run on its device against its caches (``caches`` is not read),
    the activation and the positions copied there; the head runs on the
    last stage's device, with ``head`` as its table where ``params`` does
    not hold it there (``tied_head``)."""
    x, positions = embed_inputs(params, inputs, cfg, rt)
    B = x.shape[0]
    dev = x.device
    li = None
    if last_index is not None:
        positions, li = mark_padding(
            positions, torch.as_tensor(last_index, device=dev))
    if stages is None:
        if caches is None:
            caches = init_caches(cfg, B, capacity, rt, dev)
        stages = [((0, cfg.num_layers), dev, caches)]
    for (lo, hi), d, c in stages:
        if hi > lo:
            x = run_layers(params, x.to(d), cfg, rt, mode="prefill",
                           caches=c, positions=positions.to(d),
                           layers=(lo, hi))
    return prefill_head(params, x, li, cfg, head), caches


def prefill_chunk(params: dict, tokens: torch.Tensor, caches: dict,
                  offsets: torch.Tensor, n_valid: torch.Tensor,
                  last_in_chunk: torch.Tensor, cfg: ModelConfig,
                  rt: Runtime = DEFAULT_RUNTIME):
    """One chunk of a batched chunked prefill (paged layers only).

    tokens        (B, C) — the next C prompt tokens of B rows
    offsets       (B,)   — tokens already prefilled per row
    n_valid       (B,)   — real tokens in this chunk (0 = padding row)
    last_in_chunk (B,)   — within-chunk index of the row's final prompt
                           token; meaningful only on a row's last chunk

    ``caches["page_table"]`` holds the rows being prefilled.  Returns
    (logits (B, V) float32 at ``last_in_chunk``, caches)."""
    pos = chunk_positions(offsets, n_valid, tokens.shape[1])
    if cfg.frontend == "vision_patches":
        pos = text_positions3(pos)
    x = embed_lib.embed_tokens(params["embed"], tokens, cfg, rt.compute_dtype)
    x = run_layers(params, x, cfg, rt, mode="chunk", caches=caches,
                   positions=pos)
    return chunk_logits(params, x, last_in_chunk, cfg), caches


def chunk_positions(offsets: torch.Tensor, n_valid: torch.Tensor,
                    C: int) -> torch.Tensor:
    """(B, C) absolute positions of a chunk's tokens; the tokens past a
    row's ``n_valid`` are marked -1 (no cache write)."""
    iota = torch.arange(C, device=offsets.device)[None]
    return torch.where(iota < n_valid[:, None], offsets[:, None] + iota, -1)


def chunk_logits(params: dict, x: torch.Tensor, last_in_chunk: torch.Tensor,
                 cfg: ModelConfig, head=None) -> torch.Tensor:
    """The final norm over a chunk's last-layer output (B, C, D), then the
    logits (B, V) float32 at each row's ``last_in_chunk``; ``head`` as in
    :func:`decode_logits`."""
    B, C = x.shape[:2]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    idx = last_in_chunk.long().clamp(0, C - 1)
    x_last = x[torch.arange(B, device=x.device), idx]
    return embed_lib.unembed(params["embed"], x_last, cfg, head)


def decode_logits(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  head=None) -> torch.Tensor:
    """The final norm over a decode step's last-layer output (B, 1, D),
    then the logits (B, V) float32; ``head`` is the unembedding's table
    where ``params`` does not hold it on ``x``'s device
    (:func:`tied_head`)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return embed_lib.unembed(params["embed"], x[:, 0], cfg, head)


def decode_step(params: dict, tokens: torch.Tensor, caches: dict,
                cur_pos: torch.Tensor, cfg: ModelConfig,
                rt: Runtime = DEFAULT_RUNTIME):
    """One decode step.  tokens (B,); cur_pos (B,) absolute positions,
    which are also the cache slots; a vision arch rotates at the text
    M-RoPE position (t = h = w = ``cur_pos``), as the JAX model does.
    Returns (logits (B, V) float32, caches)."""
    x = embed_lib.embed_tokens(params["embed"], tokens[:, None], cfg,
                               rt.compute_dtype)
    positions = cur_pos[:, None]
    if cfg.frontend == "vision_patches":
        positions = text_positions3(positions)
    x = run_layers(params, x, cfg, rt, mode="decode", caches=caches,
                   positions=positions)
    return decode_logits(params, x, cfg), caches
