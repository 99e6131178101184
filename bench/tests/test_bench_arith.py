"""The yardstick's arithmetic against counts worked by hand: model
operations a token, MFU, the paged kernel's roofline, the timeline's
busy and idle seconds, and the import guard."""

import math

import pytest

from bench import flops, guard, spec, weights
from bench import timeline as T
from bench.reference import llama
from bench.serve import Call, Phase

# D=2, H=1, Hk=1, Dh=2, F=3, one layer, V=5: attention 2*2 + 2*2*2 + 2*2
# = 16 parameters, the FFN 3*2*3 = 18, the head 2*5 = 10
SMALL = {"D": 2, "H": 1, "Hk": 1, "Dh": 2, "F": 3, "L": 1, "V": 5,
         "E": 0, "K": 0, "tied": False}


class Run:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_yi9b_parameters_by_hand():
    s = llama.sizes(spec.read_json(spec.BENCH / "configs" / "yi9b.json"))
    p = llama.matmul_params(s)
    per_layer = (4096 * 4096 + 2 * 4096 * 512 + 4096 * 4096
                 + 3 * 4096 * 11008)
    assert per_layer == 173_015_040
    assert p["layers"] == 48 * per_layer == 8_304_721_920
    assert p["head"] == 262_144_000
    # with the input table and the norms: the published 8.83 B
    total = p["layers"] + p["head"] + 64000 * 4096 + 97 * 4096
    assert abs(total / 1e9 - 8.83) < 0.01
    assert llama.token_flops(s, 10, 100, 2) == \
        2 * 8_304_721_920 * 10 + 4 * 32 * 128 * 48 * 100 \
        + 2 * 262_144_000 * 2 == 167_221_657_600


def test_window_mfu_by_hand():
    ph = Phase(t0=0.0, t1=2.0)
    ph.decode = [Call(0, 1, rows=4, live=3, ctx=30, kernel_toks=0)]
    ph.prefill = [Call(0, 1, rows=1, live=5, ctx=15, kernel_toks=0)]
    run = Run(phase=ph, sizes=SMALL, arch=spec.load_arch("llama"),
              dtype_name="bfloat16", cards=1)
    # 8 tokens through 34 layer parameters, 45 lengths attended at
    # 4 * 1 * 2 a layer, 4 rows through the 10 head parameters
    ops = 2 * 34 * 8 + 4 * 1 * 2 * 1 * 45 + 2 * 10 * 4
    assert ops == 984
    want = 100.0 * ops / (2.0 * 989e12)
    for name in ("mfu_decode", "mfu_prefill"):
        assert spec.load_reader(name)(run) == pytest.approx(want, rel=1e-12)


def test_paged_cost_by_hand():
    f, b = flops.paged_cost([60, 40], 0, h=2, hk=1, dh=4, esize=2, b=3,
                            max_pages=5)
    assert f == 4 * 2 * 4 * 100 == 3200
    assert b == 100 * 1 * 4 * 2 * 2 + 2 * 3 * 2 * 4 * 2 + 3 * 5 * 4 + 3 * 4
    assert b == 1768
    assert flops.least_s(f, b, "bfloat16") == 1768 / 3.35e12
    assert flops.least_s(1e15, 1, "bfloat16") == 1e15 / 989e12


def test_paged_roofline_by_hand():
    tl = T.Timeline(t0=0.0, t1=1.0)
    tl.ops = {0: [(0.1, 0.1 + 1e-6, "void paged_split_mma_kernel<128, 8>"),
                  (0.2, 0.2 + 3e-6, "void paged_split_mma_kernel<128, 8>"),
                  (0.3, 0.4, "gemm")]}
    ph = Phase(decode=[Call(0, 1, rows=3, live=3, ctx=0, kernel_toks=100)])
    run = Run(timeline=tl, traced=ph, sizes={"H": 2, "Hk": 1, "Dh": 4},
              esize=2, pages_seq=5, dtype_name="bfloat16")
    want = 100.0 * (1768 / 3.35e12) / 2e-6
    assert spec.load_reader("paged.roofline")(run) == pytest.approx(want)
    # nothing to read: no launch of the kernel in the trace
    tl.ops = {0: [(0.3, 0.4, "gemm")]}
    assert spec.load_reader("paged.roofline")(run) is None


def test_timeline_busy_idle_and_breakdown():
    tl = T.Timeline(t0=0.0, t1=5.0)
    tl.ops = {0: [(0.0, 1.0, "a"), (0.5, 2.0, "b"), (3.0, 4.0, "a")]}
    tl.spans = [(0.0, 5.0, "bench.traced"), (1.9, 3.1, "bench.decode"),
                (1.5, 3.5, "bench.step")]
    assert tl.busy_intervals(0) == [(0.0, 2.0), (3.0, 4.0)]
    assert tl.busy_s(0) == 3.0
    assert tl.idle_gaps(0) == [(2.0, 3.0), (4.0, 5.0)]
    assert tl.host_at(2.5) == "bench.decode"
    assert tl.host_at(3.3) == "bench.step"
    assert tl.host_at(4.5) == "none"
    b = T.breakdown(tl, 1)
    assert b["device_ops"] == [["a", 2.0], ["b", 1.5]]
    assert b["idle_gaps"] == [["bench.decode", 1.0], ["none", 1.0]]
    run = Run(timeline=tl, cards=1)
    assert spec.load_reader("device.idle_share")(run) == pytest.approx(40.0)
    # two cards, the second idle all through: the mean busy share halves
    assert tl.mean_busy_s(2) == 1.5
    assert tl.device_s_within([(0.4, 0.6)]) == pytest.approx(1.5)


@pytest.mark.parametrize("name,hit", [
    ("repro_torch", False), ("repro_torch.serving.engine", False),
    ("reprox", False), ("jaxtyping", False), ("bench", False),
    ("repro", True), ("repro.config", True), ("jax", True),
    ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True)])
def test_import_guard_matches_top_level_names_whole(name, hit):
    assert bool(guard.forbidden_modules([name])) == hit


def test_weights_are_seeded_and_laid_out():
    import torch

    conf = {"hidden_size": 8, "intermediate_size": 12,
            "num_attention_heads": 2, "num_key_value_heads": 1,
            "head_dim": 4, "num_hidden_layers": 2, "vocab_size": 16}
    a = weights.make_params(llama, conf, 2**31 + 3, "cpu", torch.float32)
    b = weights.make_params(llama, conf, 2**31 + 3, "cpu", torch.float32)
    c = weights.make_params(llama, conf, 2**31 + 4, "cpu", torch.float32)
    assert torch.equal(a["layers"][1]["wd"], b["layers"][1]["wd"])
    assert not torch.equal(a["layers"][1]["wd"], c["layers"][1]["wd"])
    assert a["layers"][0]["wq"].shape == (8, 8)
    assert a["layers"][0]["wk"].shape == (8, 4)
    assert a["layers"][0]["wd"].shape == (12, 8)
    assert a["embed"]["untok"].shape == (16, 8)
    assert a["layers"][0]["ln1"].shape == (8,)
    assert torch.equal(a["final_norm"], b["final_norm"])
    assert not torch.equal(a["layers"][0]["ln1"], a["layers"][0]["ln2"])
    big = weights.make_params(llama, dict(conf, hidden_size=256,
                                          intermediate_size=512), 1, "cpu",
                              torch.float32)
    std = float(big["layers"][0]["wg"].std())
    assert abs(std * math.sqrt(256) - 1.0) < 0.02
    norms = torch.cat([big["final_norm"]] +
                      [w[k] for w in big["layers"] for k in ("ln1", "ln2")])
    assert abs(float(norms.std()) / weights.NORM_STD - 1.0) < 0.1


def test_sparse_expert_layout():
    import torch

    conf = {"hidden_size": 8, "intermediate_size": 6,
            "num_attention_heads": 2, "num_key_value_heads": 1,
            "head_dim": 4, "num_hidden_layers": 1, "vocab_size": 16,
            "num_local_experts": 4, "num_experts_per_tok": 2}
    p = weights.make_params(llama, conf, 9, "cpu", torch.bfloat16)
    moe = p["layers"][0]["moe"]
    assert moe["router"].shape == (8, 4) and moe["router"].dtype == \
        torch.float32
    assert moe["wg"].shape == moe["wu"].shape == (4, 8, 6)
    assert moe["wd"].shape == (4, 6, 8) and moe["wd"].dtype == torch.bfloat16
    assert "wg" not in p["layers"][0]
    # a token multiplies through its top 2 experts and the router
    s = llama.sizes(conf)
    attn = 8 * 8 + 2 * 8 * 4 + 8 * 8
    assert llama.matmul_params(s)["layers"] == attn + 2 * 3 * 8 * 6 + 8 * 4
