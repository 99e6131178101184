"""Seeded weights on the device, in the port's parameter layout, made in a
few large calls.

The layout is ``repro_torch.models.model``'s (the JAX package's ``(in,
out)`` matrices, norms stored as ``w`` for a scale of ``1 + w``)::

    {"embed": {"tok": (V, D), "untok": (V, D)}, "final_norm": (D,),
     "layers": [{"ln1", "wq", "wk", "wv", "wo", "ln2",
                 "wg", "wu", "wd"}]}        # dense FFN, or
                "moe": {"router" (D, E) float32, "wg", "wu" (E, D, F),
                        "wd" (E, F, D)}      # sparse experts

Every matrix is normal with a standard deviation of ``1 / sqrt(fan_in)``,
and every norm's ``w`` normal with a standard deviation of ``NORM_STD``,
so that a norm whose scale is lost shows in the logits.  The matrices of
one fan-in and dtype are views of one flat tensor drawn by one
``torch.randn`` call from a generator on the device seeded with
``--seed``, and scaled by one multiply; the norms, one more such tensor
drawn last.  Both the program and the plain reference are handed these
tensors.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

NORM_STD = 0.1


def sizes(conf: dict) -> Dict[str, int]:
    """The sizes the layout needs, from a configuration file's published
    keys."""
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
    draw order; norms are not listed (``norms`` draws them)."""
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


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value


def make_params(conf: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weights of a configuration file's model, from ``seed``."""
    s = sizes(conf)
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    tree: dict = {"embed": {}, "layers": []}
    for _ in range(s["L"]):
        tree["layers"].append({"moe": {}} if s["E"] else {})
    groups: Dict[tuple, list] = defaultdict(list)
    for path, shape, fan_in, dt in leaves(s):
        groups[(fan_in, dt)].append((path, shape))
    for (fan_in, dt), members in groups.items():
        tdt = torch.float32 if dt == "float32" else dtype
        total = sum(math.prod(shape) for _, shape in members)
        flat = torch.randn(total, generator=gen, dtype=tdt, device=device)
        flat.mul_(1.0 / math.sqrt(fan_in))
        off = 0
        for path, shape in members:
            n = math.prod(shape)
            _put(tree, path, flat[off:off + n].view(shape))
            off += n
    _norms(tree, s, gen, device, dtype)
    return tree


def norm_paths(s: Dict[str, int]) -> List[tuple]:
    """Every norm weight's path, in draw order; each is ``(D,)``."""
    return [("final_norm",)] + [("layers", i, k) for i in range(s["L"])
                                for k in ("ln1", "ln2")]


def _norms(tree: dict, s: Dict[str, int], gen, device, dtype) -> None:
    paths = norm_paths(s)
    flat = torch.randn(len(paths) * s["D"], generator=gen, dtype=dtype,
                       device=device)
    flat.mul_(NORM_STD)
    for i, path in enumerate(paths):
        _put(tree, path, flat[i * s["D"]:(i + 1) * s["D"]])
