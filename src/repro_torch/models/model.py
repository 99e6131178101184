"""The dense decoder for serving: weights, chunked prefill, decode
(counterpart of ``repro.models.model``, attention kinds only).

Parameters are a plain dict of tensors, one entry per layer, with the JAX
package's ``(in, out)`` weight layout::

    {"embed": {"tok": (V, D), "untok": (V, D)}, "final_norm": (D,),
     "layers": [{"ln1", "wq", "wk", "wv", "wo", "ln2", "wg", "wu", "wd"}]}

Caches are the serving engine's paged pools (``serving.kv_cache``)::

    {"layers": [{"k_pages": (P, page, Hk, Dh), "v_pages": ...}],
     "page_table": (B, max_pages) int32}

one page table shared by every layer.  The pools are updated **in place**
(``index_put_``): a full-width pool is gigabytes, and a functional copy per
layer per step would double it.  ``run_layers`` is a loop over layers.
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_lib
from repro_torch.models import embedding as embed_lib
from repro_torch.models.common import (DEFAULT_RUNTIME, Runtime, dense_init,
                                       rms_norm, rope_tables, rotate, swiglu)

PAGED_KINDS = ("attn", "global")
# the slice of the port that brings each layer kind this one refuses
_LATER_KINDS = {
    "local": "the exact-length prefill and ring-cache slice",
    "rglru": "the other-architectures slice",
    "mlstm": "the other-architectures slice",
    "slstm": "the other-architectures slice",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for an arch this slice cannot run:
    every layer must be a paged attention kind."""
    for kind in set(cfg.layer_kinds()):
        if kind not in PAGED_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: layer kind {kind!r} is not ported yet — it "
                f"comes with {_LATER_KINDS[kind]}; this slice serves "
                f"{PAGED_KINDS} layers only")


# ---------------------------------------------------------------------------
# Parameter init (on the device, tensor by tensor)
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int, rt: Runtime = DEFAULT_RUNTIME,
                device="cpu") -> dict:
    """Random weights from ``seed`` with ``repro.models.common.dense_init``'s
    recipe (normal x 1/sqrt(fan_in), zero norm weights), made on ``device``
    one tensor at a time in ``rt.param_dtype``.  The numbers differ from
    the JAX package's (another generator); tests that compare the two
    convert the JAX weights instead (``models.convert``)."""
    check_supported(cfg)
    device = torch.device(device)
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
    for _ in range(cfg.num_layers):
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


# ---------------------------------------------------------------------------
# Paged KV addressing (once per step: every layer's pool has one layout)
# ---------------------------------------------------------------------------


def _step_index(mode: str, positions: torch.Tensor, page_table: torch.Tensor,
                page_size: int) -> dict:
    """Where each token's K/V goes in the pools, and what attention reads.

    Decode: ``page``/``off`` of the current token and ``seq_lens`` for the
    kernel.  Chunk: ``page``/``off``/``keep`` for ``_write_prefill_paged``
    and the row's table ``pt`` for the gather.  Positions marked ``-1``
    (padding) must not touch a live page.  JAX drops their scatter as out
    of bounds; torch indexing would raise instead, and selecting only the
    valid positions would cost a device-to-host sync.  So a pad position is
    sent to scratch page 0, offset 0, with ``keep`` False."""
    pos = positions.long()
    pt = page_table.long()
    if mode == "decode":
        cur = pos[:, 0]
        return {"page": pt.gather(1, (cur // page_size)[:, None])[:, 0],
                "off": cur % page_size,
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


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


def _attn_layer(w: dict, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, mode: str, cache: dict,
                page_table: torch.Tensor, rope: tuple,
                idx: dict) -> torch.Tensor:
    B, S = x.shape[:2]
    H, Hk, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    q = (h @ w["wq"]).reshape(B, S, H, Dh)
    k = (h @ w["wk"]).reshape(B, S, Hk, Dh)
    v = (h @ w["wv"]).reshape(B, S, Hk, Dh)
    if cfg.use_qk_norm:
        q = rms_norm(q, w["q_norm"], cfg.norm_eps)
        k = rms_norm(k, w["k_norm"], cfg.norm_eps)
    q, k = rotate(q, *rope), rotate(k, *rope)

    if mode == "decode":
        cache["k_pages"].index_put_((idx["page"], idx["off"]), k[:, 0])
        cache["v_pages"].index_put_((idx["page"], idx["off"]), v[:, 0])
        out = kops.paged_decode_attention(
            q[:, 0], cache["k_pages"], cache["v_pages"], page_table,
            idx["seq_lens"])[:, None]                       # (B, 1, H, Dh)
    else:
        # write the chunk's KV into the pool, then attend the chunk's
        # queries against the row's whole gathered extent
        _write_prefill_paged(cache, k, v, idx)
        pt = idx["pt"]
        n_ctx = pt.shape[1] * cache["k_pages"].shape[1]
        kg = cache["k_pages"][pt].reshape(B, n_ctx, Hk, Dh)
        vg = cache["v_pages"][pt].reshape(B, n_ctx, Hk, Dh)
        out = attn_lib.chunk_attention(
            q, kg, vg, torch.arange(n_ctx, device=x.device), positions)

    x = x + out.reshape(B, S, H * Dh) @ w["wo"]
    if cfg.d_ff > 0:
        x = x + swiglu(rms_norm(x, w["ln2"], cfg.norm_eps), w["wg"], w["wu"],
                       w["wd"])
    return x


def run_layers(params: dict, x: torch.Tensor, cfg: ModelConfig, rt: Runtime,
               *, mode: str, caches: dict,
               positions: torch.Tensor) -> torch.Tensor:
    """Apply every layer in order; the caches' pools change in place.  The
    RoPE tables and the pool addressing depend on the positions only, so
    they are computed once here for all layers."""
    if mode not in ("decode", "chunk"):
        raise ValueError(f"mode must be 'decode' or 'chunk', got {mode!r}")
    page_table = caches["page_table"]
    page_size = caches["layers"][0]["k_pages"].shape[1]
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                       cfg.rope_scaling)
    idx = _step_index(mode, positions, page_table, page_size)
    for w, cache in zip(params["layers"], caches["layers"]):
        x = _attn_layer(w, x, cfg, positions=positions, mode=mode,
                        cache=cache, page_table=page_table, rope=rope,
                        idx=idx)
    return x


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------


def prefill_chunk(params: dict, tokens: torch.Tensor, caches: dict,
                  offsets: torch.Tensor, n_valid: torch.Tensor,
                  last_in_chunk: torch.Tensor, cfg: ModelConfig,
                  rt: Runtime = DEFAULT_RUNTIME):
    """One chunk of a batched chunked prefill.

    tokens        (B, C) — the next C prompt tokens of B rows
    offsets       (B,)   — tokens already prefilled per row
    n_valid       (B,)   — real tokens in this chunk (0 = padding row)
    last_in_chunk (B,)   — within-chunk index of the row's final prompt
                           token; meaningful only on a row's last chunk

    ``caches["page_table"]`` holds the rows being prefilled.  Returns
    (logits (B, V) float32 at ``last_in_chunk``, caches)."""
    B, C = tokens.shape
    iota = torch.arange(C, device=tokens.device)[None]
    pos = torch.where(iota < n_valid[:, None], offsets[:, None] + iota, -1)
    x = embed_lib.embed_tokens(params["embed"], tokens, cfg, rt.compute_dtype)
    x = run_layers(params, x, cfg, rt, mode="chunk", caches=caches,
                   positions=pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    idx = last_in_chunk.long().clamp(0, C - 1)
    x_last = x[torch.arange(B, device=x.device), idx]
    return embed_lib.unembed(params["embed"], x_last, cfg), caches


def decode_step(params: dict, tokens: torch.Tensor, caches: dict,
                cur_pos: torch.Tensor, cfg: ModelConfig,
                rt: Runtime = DEFAULT_RUNTIME):
    """One decode step.  tokens (B,); cur_pos (B,) absolute positions.
    Returns (logits (B, V) float32, caches)."""
    x = embed_lib.embed_tokens(params["embed"], tokens[:, None], cfg,
                               rt.compute_dtype)
    x = run_layers(params, x, cfg, rt, mode="decode", caches=caches,
                   positions=cur_pos[:, None])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return embed_lib.unembed(params["embed"], x[:, 0], cfg), caches

