"""The plain reference of a llama-architecture decoder (Yi): float32, TF32
off, one layer at a time, no cache, no batching, no kernel.

It follows the published architecture (pre-norm RMSNorm, grouped-query
attention with rotary embeddings over split halves, SwiGLU) and reads the
weights in the port's layout: ``(in, out)`` matrices, and norm weights
stored as ``w`` for a scale of ``1 + w``, the one departure from the
published ``w``.  It imports torch alone.

``fp8=True`` is the control: every matrix product (the projections, the
FFN and the unembedding) takes its operands rounded to float8 e4m3, the
activations with a scale a row and the weights with a scale an output
column, and multiplies them in float32: the step below bfloat16 that
would tempt a faster path.

Beside the reference, the module holds what the harness asks of the
configuration's architecture (``bench/README.md``): ``sizes``,
``layout`` (the weights it draws, in the port's layout), ``window_ops``
(the model operations of a window's calls) and ``CONFIG_FIELDS`` (the
published keys that must equal the port's ``ModelConfig`` fields).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import torch

FP8_MAX = 448.0
# published keys of a configuration file -> the port's ModelConfig fields
CONFIG_FIELDS = {"hidden_size": "d_model", "num_attention_heads": "num_heads",
                 "num_key_value_heads": "num_kv_heads",
                 "head_dim": "head_dim", "num_hidden_layers": "num_layers",
                 "vocab_size": "vocab_size", "rope_theta": "rope_theta",
                 "rms_norm_eps": "norm_eps",
                 "tie_word_embeddings": "tie_embeddings",
                 "max_position_embeddings": "max_position_embeddings",
                 "intermediate_size": "d_ff"}
# the port's ModelConfig fields this reference does not model: a
# configuration that names it must hold these values
PROGRAM_FIELDS = {"block_pattern": ("attn",), "window_size": 0, "moe": None,
                  "use_qk_norm": False, "logit_softcap": 0.0,
                  "scale_embeddings": False, "frontend": "token",
                  "rope_scaling": 1.0}


@contextlib.contextmanager
def exact_float32():
    """TF32 off for the block (the card would otherwise round float32
    products to TF32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = saved


def to_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale a slice along ``dim``
    (the scale maps the slice's largest magnitude to 448), back in
    float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        return to_fp8(x, -1) @ to_fp8(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (S, heads, Dh) at positions 0 .. S-1, the
    angles in float64."""
    s, _, dh = x.shape
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64,
                                       device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int = 1024) -> torch.Tensor:
    """q (S, H, Dh), k and v (S, Hk, Dh): query head ``h`` reads key head
    ``h // (H / Hk)``; queries in blocks of ``block``."""
    s, h, dh = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    for lo in range(0, s, block):
        hi = min(s, lo + block)
        sc = torch.einsum("qhd,khd->hqk", q[lo:hi], k[:hi]) / math.sqrt(dh)
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        kpos = torch.arange(hi, device=q.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        out[lo:hi] = torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1),
                                  v[:hi])
    return out


def _layer(x: torch.Tensor, w: dict, conf: dict, fp8: bool) -> torch.Tensor:
    s = x.shape[0]
    d = int(conf["hidden_size"])
    nh = int(conf["num_attention_heads"])
    nk = int(conf["num_key_value_heads"])
    dh = int(conf.get("head_dim", d // nh))
    eps = float(conf["rms_norm_eps"])
    h = rms_norm(x, w["ln1"], eps)
    q = _mm(h, w["wq"], fp8).view(s, nh, dh)
    k = _mm(h, w["wk"], fp8).view(s, nk, dh)
    v = _mm(h, w["wv"], fp8).view(s, nk, dh)
    theta = float(conf["rope_theta"])
    a = causal_attention(rope(q, theta), rope(k, theta), v)
    x = x + _mm(a.reshape(s, nh * dh), w["wo"], fp8)
    h = rms_norm(x, w["ln2"], eps)
    g = torch.nn.functional.silu(_mm(h, w["wg"], fp8))
    return x + _mm(g * _mm(h, w["wu"], fp8), w["wd"], fp8)


def logits(params: dict, conf: dict, seqs: Sequence[Sequence[int]],
           starts: Sequence[int], fp8: bool = False,
           row_block: int = 512) -> List[torch.Tensor]:
    """For each token sequence, the float32 logits (len - start, V) at
    positions ``start .. len - 1`` (position ``p``'s logits rank the token
    at ``p + 1``).  The layers run one at a time over every sequence, each
    layer's weights copied to float32 for its turn."""
    dev = params["embed"]["tok"].device
    eps = float(conf["rms_norm_eps"])
    with exact_float32(), torch.no_grad():
        xs = [params["embed"]["tok"][torch.as_tensor(list(s), device=dev)]
              .float() for s in seqs]
        for w in params["layers"]:
            wf = {k: v.float() for k, v in w.items()}
            xs = [_layer(x, wf, conf, fp8) for x in xs]
            del wf
        head = params["embed"]["tok" if conf.get("tie_word_embeddings")
                               else "untok"].float().t()
        if fp8:
            head = to_fp8(head, 0)
        out = []
        for x, start in zip(xs, starts):
            x = rms_norm(x[start:], params["final_norm"], eps)
            rows = [(to_fp8(x[i:i + row_block], -1) if fp8
                     else x[i:i + row_block]) @ head
                    for i in range(0, x.shape[0], row_block)]
            out.append(torch.cat(rows))
        return out


# -- what the harness asks of the architecture -------------------------------


def sizes(conf: dict) -> Dict[str, int]:
    """The sizes the layout needs, from a configuration file's published
    keys (experts keyed as Mixtral and PhiMoE publish them)."""
    d = int(conf["hidden_size"])
    h = int(conf["num_attention_heads"])
    out = {"D": d, "H": h, "Hk": int(conf["num_key_value_heads"]),
           "Dh": int(conf.get("head_dim", d // h)),
           "L": int(conf["num_hidden_layers"]),
           "V": int(conf["vocab_size"]),
           "F": int(conf["intermediate_size"]),
           "E": int(conf.get("num_local_experts", 0)),
           "K": int(conf.get("num_experts_per_tok", 0)),
           "tied": bool(conf.get("tie_word_embeddings", False))}
    return out


def leaves(s: Dict[str, int]) -> List[Tuple[tuple, tuple, int, str]]:
    """``(path, shape, fan_in, dtype name)`` of every random matrix, in
    draw order; norms are not listed (``norm_paths``)."""
    D, H, Hk, Dh, V, F = s["D"], s["H"], s["Hk"], s["Dh"], s["V"], s["F"]
    out = [(("embed", "tok"), (V, D), D, "model")]
    if not s["tied"]:
        out.append((("embed", "untok"), (V, D), D, "model"))
    for i in range(s["L"]):
        out += [(("layers", i, "wq"), (D, H * Dh), D, "model"),
                (("layers", i, "wk"), (D, Hk * Dh), D, "model"),
                (("layers", i, "wv"), (D, Hk * Dh), D, "model"),
                (("layers", i, "wo"), (H * Dh, D), H * Dh, "model")]
        if s["E"]:
            E = s["E"]
            out += [(("layers", i, "moe", "router"), (D, E), D, "float32"),
                    (("layers", i, "moe", "wg"), (E, D, F), D, "model"),
                    (("layers", i, "moe", "wu"), (E, D, F), D, "model"),
                    (("layers", i, "moe", "wd"), (E, F, D), F, "model")]
        else:
            out += [(("layers", i, "wg"), (D, F), D, "model"),
                    (("layers", i, "wu"), (D, F), D, "model"),
                    (("layers", i, "wd"), (F, D), F, "model")]
    return out


def norm_paths(s: Dict[str, int]) -> List[tuple]:
    """Every norm weight's path, in draw order; each is ``(D,)``."""
    return [("final_norm",)] + [("layers", i, k) for i in range(s["L"])
                                for k in ("ln1", "ln2")]


def layout(conf: dict) -> Tuple[list, list]:
    """The weights a configuration draws (``bench.weights.make_params``):
    every matrix as ``(path, shape, fan_in, dtype name)`` in draw order,
    and every norm weight as ``(path, shape)`` in draw order.  The layout
    is ``repro_torch.models.model``'s::

        {"embed": {"tok": (V, D), "untok": (V, D)}, "final_norm": (D,),
         "layers": [{"ln1", "wq", "wk", "wv", "wo", "ln2",
                     "wg", "wu", "wd"}]}        # dense FFN, or
                    "moe": {"router" (D, E) float32, "wg", "wu" (E, D, F),
                            "wd" (E, F, D)}      # sparse experts
    """
    s = sizes(conf)
    return leaves(s), [(p, (s["D"],)) for p in norm_paths(s)]


def matmul_params(s: Dict[str, int]) -> Dict[str, int]:
    """Parameters that a token multiplies through: ``layers`` (every
    layer's projections and the FFN a token uses: its top-k experts and
    the router on a sparse model) and ``head`` (the unembedding)."""
    D, H, Hk, Dh, F = s["D"], s["H"], s["Hk"], s["Dh"], s["F"]
    attn = D * H * Dh + 2 * D * Hk * Dh + H * Dh * D
    ffn = s["K"] * 3 * D * F + D * s["E"] if s["E"] else 3 * D * F
    return {"layers": s["L"] * (attn + ffn), "head": D * s["V"]}


def token_flops(s: Dict[str, int], tokens: int, ctx_sum: int,
                head_rows: int) -> float:
    """Model operations of ``tokens`` real tokens whose attended lengths
    sum to ``ctx_sum`` (a token at position ``p`` attends ``p + 1``), with
    ``head_rows`` rows through the unembedding: two a multiply-add over
    the layers' parameters, ``4 * H * Dh`` a token attended a layer, two
    a head parameter a row."""
    p = matmul_params(s)
    return (2.0 * p["layers"] * tokens
            + 4.0 * s["H"] * s["Dh"] * s["L"] * ctx_sum
            + 2.0 * p["head"] * head_rows)


def window_ops(s: Dict[str, int], phase) -> float:
    """The model operations of a phase's calls: every real token of the
    decode calls (live rows, at their lengths, each through the head) and
    of the prefill calls (real tokens, causal lengths, each chunk row
    through the head).  Every layer attends the whole context."""
    toks = sum(c.live for c in phase.decode) + \
        sum(c.live for c in phase.prefill)
    ctx = sum(c.ctx for c in phase.decode) + sum(c.ctx for c in phase.prefill)
    head = sum(c.live for c in phase.decode) + \
        sum(c.rows for c in phase.prefill)
    return token_flops(s, toks, ctx, head)
