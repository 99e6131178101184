"""``correct`` comes out false when the timed path is broken underneath.

Each test drives a whole run of the tiny cell on the CPU (the harness's
look for a card is the command line's, which these runs skip), with one
fault planted in the program: a prefill step that leaves the cache as it
was, half of a decode batch left out, a token altered where it is
produced, the norms' scales lost.  A run with no fault is correct; the
float8 control, judged in the program's place, is not.  The cells run on
one card, so there is no exchange between cards to leave out."""

import time

import torch

from bench import check, run, serve
from bench.tests import tiny

SEED = 2**31 + 77


def run_tiny(tmp_path, seconds=1.5):
    cell = tiny.tiny_cell(tmp_path)
    return run.run_cell(cell, SEED, seconds, False, "cpu",
                        time.perf_counter(), root=tmp_path)


def test_sound_run_is_correct(tmp_path):
    res = run_tiny(tmp_path)
    assert res["correct"], res["checks"]
    assert res["checks"]["tokens_compared"]["value"] >= 8


def test_state_left_unchanged(tmp_path, monkeypatch):
    from repro_torch.models import model as M
    monkeypatch.setattr(M, "_write_prefill_paged",
                        lambda cache, k, v, idx: None)
    assert not run_tiny(tmp_path)["correct"]


def test_half_the_batch_left_out(tmp_path, monkeypatch):
    from repro_torch.serving import backend as B
    fn = B.LocalBackend._decode_fn

    def half(params, caches, tokens, cur_pos, row0, noise, temp, top_k,
             top_p, *, cfg, rt, mb_size, sampled):
        toks, lps = fn(params, caches, tokens, cur_pos, row0, noise, temp,
                       top_k, top_p, cfg=cfg, rt=rt, mb_size=mb_size,
                       sampled=sampled)
        h = mb_size // 2
        return torch.cat([toks[:h], toks[:h]]), torch.cat([lps[:h],
                                                          lps[:h]])

    monkeypatch.setattr(B.LocalBackend, "_decode_fn", staticmethod(half))
    assert not run_tiny(tmp_path)["correct"]


def test_token_altered_where_produced(tmp_path, monkeypatch):
    from repro_torch.serving import backend as B
    greedy = B.greedy
    monkeypatch.setattr(B, "greedy",
                        lambda logits: (greedy(logits) + 1) % logits.shape[-1])
    assert not run_tiny(tmp_path)["correct"]


def test_norm_scales_lost(tmp_path, monkeypatch):
    from repro_torch.models import model as M
    rms = M.rms_norm
    monkeypatch.setattr(M, "rms_norm",
                        lambda x, w, eps: rms(x, torch.zeros_like(w), eps))
    assert not run_tiny(tmp_path)["correct"]


def test_control_is_not_correct(tmp_path):
    cell = tiny.tiny_cell(tmp_path)
    runner = serve.Runner(cell, SEED, "cpu")
    runner.warm_up()
    runner.run_phase(1.5)
    finished = runner.finished_greedy()
    runner.free_engine()
    lim = cell.limits
    sample = check.draw_sample(finished, SEED, lim["sample_tokens"],
                               lim["sample_requests"])
    r = check.gaps(cell.arch, runner.params, cell.config, sample,
                   control=True)
    program_ok, _ = check.judge(r, lim, 0)
    control_ok, checks = check.judge(
        dict(r, logit_gap_max=r["control_gap"]), lim, 0)
    assert program_ok
    assert not control_ok, checks
