"""The decoder for serving: weights, chunked and exact-length prefill,
decode (counterpart of ``repro.models.model``; attention kinds and the
Griffin recurrent kind ``"rglru"``).

Parameters are a plain dict of tensors, one entry per layer, with the JAX
package's ``(in, out)`` weight layout::

    {"embed": {"tok": (V, D), "untok": (V, D)}, "final_norm": (D,),
     "layers": [{"ln1", "wq", "wk", "wv", "wo", "ln2", "wg", "wu", "wd"}]}

(``"untok"`` is absent with tied embeddings; ``"q_norm"``/``"k_norm"``
join a layer with qk-norm.)  An ``"rglru"`` layer holds ``"ln1", "wg",
"wx", "conv_w", "conv_b", "gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b",
"lam", "wo"`` and its MLP under ``"ln2", "wg_mlp", "wu", "wd"``; the gate
biases and ``"lam"`` are float32 whatever ``param_dtype`` is
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

or a recurrent state a row (``"rglru"``)::

    {"h": (B, Dr) float32, "conv": (B, cw-1, Dr) compute dtype}

and one page table shared by every paged layer (absent when no layer is
paged).  Pools, rings and recurrent states are updated **in place**
(``index_put_``, slice assignment, ``copy_``): a full-width pool is
gigabytes, and a functional copy per layer per step would double it; and
the serving backend hands the model a row *view* of its caches
(``serving.kv_cache.slot_view``), through which only in-place writes
reach the batch-wide tensors.  ``run_layers`` is a loop over layers, or
over one contiguous range of them (a pipeline stage, ``core.pipeline``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ATTN_KINDS, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_lib
from repro_torch.models import embedding as embed_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models.common import (DEFAULT_RUNTIME, Runtime, dense_init,
                                       resolve_device, rms_norm, rope_tables,
                                       rotate_qk, swiglu)

PAGED_KINDS = ("attn", "global")
SERVED_KINDS = ATTN_KINDS + ("rglru",)
LOCAL_ROPE_THETA = 10000.0      # gemma3: local layers keep the small base
# the slice of the port that brings each layer kind it refuses
_LATER_KINDS = {
    "mlstm": "the other-architectures slice (xLSTM)",
    "slstm": "the other-architectures slice (xLSTM)",
}
# leaves of an "rglru" layer that stay float32 whatever param_dtype is
FLOAT32_LEAVES = ("gate_a_b", "gate_x_b", "lam")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for an arch the port cannot run yet:
    every layer must be an attention kind or ``"rglru"``."""
    for kind in set(cfg.layer_kinds()):
        if kind not in SERVED_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} is not ported yet — it "
                f"comes with {_LATER_KINDS[kind]}; the port serves "
                f"{SERVED_KINDS} layers")


def layer_theta(kind: str, cfg: ModelConfig) -> float:
    """RoPE base of a layer: gemma3's sliding-window layers keep 10k."""
    if kind == "local" and cfg.window_size:
        return LOCAL_ROPE_THETA
    return cfg.rope_theta


# ---------------------------------------------------------------------------
# Parameter init (on the device, tensor by tensor)
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int, rt: Runtime = DEFAULT_RUNTIME,
                device=None) -> dict:
    """Random weights from ``seed`` with ``repro.models.common.dense_init``'s
    recipe (normal x 1/sqrt(fan_in), zero norm weights), made on ``device``
    (``cuda`` unless asked, see ``resolve_device``) one tensor at a time in
    ``rt.param_dtype``.  The numbers differ from the JAX package's (another
    generator); tests that compare the two convert the JAX weights instead
    (``models.convert``)."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pd = rt.param_dtype
    D, F = cfg.d_model, cfg.d_ff
    H, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def dense(shape, fan_in=None):
        return dense_init(gen, shape, pd, device, fan_in)

    def zeros(n):
        return torch.zeros((n,), dtype=pd, device=device)

    embed = {"tok": dense((cfg.vocab_size, D), fan_in=D)}
    if not cfg.tie_embeddings:
        embed["untok"] = dense((cfg.vocab_size, D), fan_in=D)
    layers = []
    for kind in cfg.layer_kinds():
        if kind == "rglru":
            layers.append(_init_rglru_layer(cfg, dense, zeros, device))
            continue
        w = {"ln1": zeros(D), "wq": dense((D, H * Dh)),
             "wk": dense((D, Hk * Dh)), "wv": dense((D, Hk * Dh)),
             "wo": dense((H * Dh, D), fan_in=H * Dh)}
        if cfg.use_qk_norm:
            w["q_norm"], w["k_norm"] = zeros(Dh), zeros(Dh)
        if F > 0:
            w.update(ln2=zeros(D), wg=dense((D, F)), wu=dense((D, F)),
                     wd=dense((F, D), fan_in=F))
        layers.append(w)
    return {"embed": embed, "final_norm": zeros(D), "layers": layers}


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


# ---------------------------------------------------------------------------
# Dense and ring caches (the JAX package's ``init_caches`` / ``_kind_cache``)
# ---------------------------------------------------------------------------


def _kind_cache(kind: str, cfg: ModelConfig, batch: int, capacity: int,
                rt: Runtime, device="cpu") -> dict:
    """A per-row cache: for an attention kind ``capacity`` slots, or a
    ring of ``window_size`` slots for ``"local"``, with int8 values and
    bf16 per-(token, head) scales when ``rt.kv_dtype == "int8"``; for
    ``"rglru"`` the recurrent state and the conv's trailing inputs."""
    if kind == "rglru":
        return {"h": torch.zeros((batch, cfg.d_rnn), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_rnn),
                                    dtype=rt.compute_dtype, device=device)}
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"layer kind {kind!r} has no cache in the "
                                  "port yet")
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
    ``_write_prefill_paged`` and the row's table ``pt`` for the gather.
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
    return {"page": torch.where(valid, pt.gather(1, p0 // page_size), 0),
            "off": torch.where(valid, p0 % page_size, 0),
            "keep": valid[..., None, None], "pt": pt}


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


def _attn_layer(kind: str, w: dict, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, mode: str, cache: dict,
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
        # queries against the row's whole gathered extent
        if "k_pages" not in cache:
            raise NotImplementedError(
                "chunked prefill supports paged attention layers only; "
                "ring (sliding-window) layers must use exact-length prefill")
        _write_prefill_paged(cache, k, v, idx)
        pt = idx["pt"]
        n_ctx = pt.shape[1] * cache["k_pages"].shape[1]
        kg = cache["k_pages"][pt].reshape(B, n_ctx, Hk, Dh)
        vg = cache["v_pages"][pt].reshape(B, n_ctx, Hk, Dh)
        out = attn_lib.chunk_attention(
            q, kg, vg, torch.arange(n_ctx, device=x.device), positions,
            window=window)
    else:
        # exact-length prefill: the whole sequence through the flash
        # kernel (its plain version on the CPU), then the cache write
        out = kops.flash_attention(q, k, v, causal=True, window=window)
        _write_prefill_cache(cache, k, v, positions, idx)

    x = x + out.reshape(B, S, H * Dh) @ w["wo"]
    if cfg.d_ff > 0:
        x = x + swiglu(rms_norm(x, w["ln2"], cfg.norm_eps), w["wg"], w["wu"],
                       w["wd"])
    return x


def _rglru_layer(w: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 positions: torch.Tensor, mode: str,
                 cache: dict) -> torch.Tensor:
    """A Griffin residual block: RG-LRU mixer, then the MLP.  In a prefill
    the positions marked -1 (right padding) are identity steps of the
    recurrence (``_recurrent_valid``).  The new state is copied into the
    cache's own tensors: they may be a row view of the batch-wide caches,
    and rebinding the dict entry would lose it."""
    if mode == "chunk":
        raise NotImplementedError(
            "chunked prefill is not supported for recurrent layers")
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    y, new = rglru_lib.rglru_block(h, w, cfg.num_heads, mode=mode,
                                   state=cache,
                                   valid=_recurrent_valid(positions, mode))
    cache["h"].copy_(new["h"])
    cache["conv"].copy_(new["conv"])
    x = x + y
    if cfg.d_ff > 0:
        x = x + swiglu(rms_norm(x, w["ln2"], cfg.norm_eps), w["wg_mlp"],
                       w["wu"], w["wd"])
    return x


def _recurrent_valid(positions: torch.Tensor, mode: str):
    """Which tokens update the recurrent state: in a prefill, the positions
    not marked -1 (right padding of a bucketed prompt); decode positions
    are all real, so no mask."""
    return positions >= 0 if mode == "prefill" else None


def run_layers(params: dict, x: torch.Tensor, cfg: ModelConfig, rt: Runtime,
               *, mode: str, caches: dict, positions: torch.Tensor,
               layers: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Apply the layers in order, every one or only ``layers = (lo, hi)``
    (a pipeline stage: layers ``lo .. hi-1``, whose weights and caches are
    ``params["layers"][lo:hi]`` and ``caches["layers"][lo:hi]``); the caches
    change in place.  The RoPE tables (one per base the attention layers
    use) and the pool addressing depend on the positions only, so they are
    computed once here for all the layers of the call."""
    if mode not in ("decode", "chunk", "prefill"):
        raise ValueError("mode must be 'decode', 'chunk' or 'prefill', "
                         f"got {mode!r}")
    lo, hi = (0, cfg.num_layers) if layers is None else layers
    kinds = cfg.layer_kinds()[lo:hi]
    ws, cs = params["layers"][lo:hi], caches["layers"][lo:hi]
    ropes = {theta: rope_tables(positions, cfg.head_dim, theta,
                                cfg.rope_scaling)
             for theta in {layer_theta(k, cfg) for k in kinds
                           if k in ATTN_KINDS}}
    page_table = caches.get("page_table")
    paged = next((c for c in cs if "k_pages" in c), None)
    idx = None if paged is None else _step_index(
        mode, positions, page_table, paged["k_pages"].shape[1])
    for kind, w, cache in zip(kinds, ws, cs):
        if kind == "rglru":
            x = _rglru_layer(w, x, cfg, positions=positions, mode=mode,
                             cache=cache)
            continue
        x = _attn_layer(kind, w, x, cfg, positions=positions, mode=mode,
                        cache=cache, page_table=page_table,
                        rope=ropes[layer_theta(kind, cfg)], idx=idx)
    return x


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            rt: Runtime = DEFAULT_RUNTIME, capacity: int = 0, caches=None,
            last_index=None):
    """Exact-length prefill of whole prompts.  tokens (B, S).  Returns
    (last_logits (B, V) float32, caches).

    ``caches`` may be pre-built (the serving engine's pools and rings,
    written in place); otherwise dense caches of ``capacity`` slots are
    made.  When the prompts are right-padded, ``last_index`` (B,) selects
    each row's true last position for the logits and marks the positions
    after it ``-1``, so the cache writes drop them.  The last position is
    taken before the final norm and the unembedding, so no (S, V) logits
    are made."""
    B, S = tokens.shape
    dev = tokens.device
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    if last_index is not None:
        li = torch.as_tensor(last_index, device=dev).long().reshape(B)
        positions = torch.where(positions > li[:, None], -1, positions)
    if caches is None:
        caches = init_caches(cfg, B, capacity, rt, dev)
    x = embed_lib.embed_tokens(params["embed"], tokens, cfg, rt.compute_dtype)
    x = run_layers(params, x, cfg, rt, mode="prefill", caches=caches,
                   positions=positions)
    x_last = x[:, -1] if last_index is None else \
        x[torch.arange(B, device=dev), li]
    x_last = rms_norm(x_last, params["final_norm"], cfg.norm_eps)
    return embed_lib.unembed(params["embed"], x_last, cfg), caches


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
                 cfg: ModelConfig) -> torch.Tensor:
    """The final norm over a chunk's last-layer output (B, C, D), then the
    logits (B, V) float32 at each row's ``last_in_chunk``."""
    B, C = x.shape[:2]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    idx = last_in_chunk.long().clamp(0, C - 1)
    x_last = x[torch.arange(B, device=x.device), idx]
    return embed_lib.unembed(params["embed"], x_last, cfg)


def decode_logits(params: dict, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """The final norm over a decode step's last-layer output (B, 1, D),
    then the logits (B, V) float32."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return embed_lib.unembed(params["embed"], x[:, 0], cfg)


def decode_step(params: dict, tokens: torch.Tensor, caches: dict,
                cur_pos: torch.Tensor, cfg: ModelConfig,
                rt: Runtime = DEFAULT_RUNTIME):
    """One decode step.  tokens (B,); cur_pos (B,) absolute positions.
    Returns (logits (B, V) float32, caches)."""
    x = embed_lib.embed_tokens(params["embed"], tokens[:, None], cfg,
                               rt.compute_dtype)
    x = run_layers(params, x, cfg, rt, mode="decode", caches=caches,
                   positions=cur_pos[:, None])
    return decode_logits(params, x, cfg), caches
