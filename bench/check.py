"""How ``correct`` is decided: served greedy tokens against the plain
reference.

Once the window has closed, a sample of the finished greedy requests is
drawn from the seed, the longest of them always in it, until it holds the
cell's ``sample_tokens`` served tokens and ``sample_requests`` requests:
several requests, so that a fault in some rows of the batch shows.  The
reference that the configuration names runs once over each prompt with
its served tokens, and each served token is scored by how far its
reference logit lies below the reference's best at its position.  The widest such gap is compared with
the cell's limit.

Sampled requests are not compared: the check holds for greedy tokens, and
a sampled token is a draw from the program's own generator, which the
reference cannot repeat.  They share every decode call with the greedy
rows, so only the sampler's own arithmetic escapes the check.

The control (``control_gap``) puts the reference in the program's place
at float8: at the same positions it reads the gap of the token that the
float8 forward ranks first, and is judged by ``judge`` as the program's
``logit_gap_max`` would be.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


SEED_SALT = 0x5EED_C4EC


def draw_sample(finished: List[dict], seed: int, tokens: int,
                requests: int) -> List[dict]:
    """The longest finished greedy request, then others in an order drawn
    from ``seed``, until the sample holds ``tokens`` served tokens and
    ``requests`` requests (or every finished greedy request)."""
    if not finished:
        return []
    by_len = sorted(finished, key=lambda r: (-len(r["tokens"]), r["id"]))
    rest = by_len[1:]
    rng = np.random.default_rng((int(seed) ^ SEED_SALT) % (1 << 64))
    order = [by_len[0]] + [rest[i] for i in rng.permutation(len(rest))]
    out, total = [], 0
    for r in order:
        if total >= tokens and len(out) >= requests:
            break
        out.append(r)
        total += len(r["tokens"])
    return out


def gaps(arch, params: dict, conf: dict, sample: List[dict],
         control: bool = False) -> Dict[str, float]:
    """``logit_gap_max`` of the served tokens (and ``control_gap`` of the
    float8 reference's first choices when ``control``), with
    ``tokens_compared`` and ``tokens_off_top`` (served tokens that are not
    the reference's first choice).  The reference is ``logits`` of
    ``arch``, the configuration's module."""
    seqs = [r["prompt"] + r["tokens"][:-1] for r in sample]
    starts = [len(r["prompt"]) - 1 for r in sample]
    ref = arch.logits(params, conf, seqs, starts)
    ctl = arch.logits(params, conf, seqs, starts, fp8=True) \
        if control else None
    worst, worst_ctl, n, off = 0.0, 0.0, 0, 0
    for i, r in enumerate(sample):
        served = torch.as_tensor(r["tokens"], device=ref[i].device)
        best = ref[i].max(dim=-1)
        gap = best.values - ref[i].gather(1, served[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        off += int((best.indices != served).sum())
        n += len(r["tokens"])
        if ctl is not None:
            top = ctl[i].argmax(dim=-1)
            g = best.values - ref[i].gather(1, top[:, None])[:, 0]
            worst_ctl = max(worst_ctl, float(g.max()))
    out = {"logit_gap_max": worst, "tokens_compared": n,
           "tokens_off_top": off}
    if control:
        out["control_gap"] = worst_ctl
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float],
          short: int) -> tuple:
    """(correct, the numbers compared with their limits)."""
    checks = {
        "logit_gap_max": {"value": readings.get("logit_gap_max"),
                          "limit": limits["logit_gap_max"]},
        "tokens_compared": {"value": readings.get("tokens_compared", 0),
                            "limit": limits["min_tokens"]},
        "short_finishes": {"value": short, "limit": 0},
    }
    gap = checks["logit_gap_max"]["value"]
    ok = (gap is not None and gap <= limits["logit_gap_max"]
          and checks["tokens_compared"]["value"] >= limits["min_tokens"]
          and short == 0)
    return ok, checks
