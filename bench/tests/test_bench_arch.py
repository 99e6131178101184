"""A configuration's architecture is its module, ``bench/reference/<name>.py``:
the weights it draws and the operations it counts.  The llama module draws
the tensors and counts the operations that the harness did before these
lived in the module (digests and values recorded from that harness), and
an architecture added as new files alone is drawn and counted by its own
module."""

import hashlib
import json
import re
import shutil

import numpy as np
import pytest
import torch

from bench import flops, serve, spec, weights
from bench.reference import llama
from bench.serve import Call, Phase
from bench.tests import tiny

SEED = 2**31 + 3
YI = {"hidden_size": 64, "intermediate_size": 160, "num_attention_heads": 4,
      "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 2,
      "vocab_size": 256, "tie_word_embeddings": False}
# H * Dh != D: the output projection is drawn in a group of its own
YI_WIDE = dict(YI, head_dim=24)
# experts keyed as Mixtral publishes them, tied embeddings
MIXTRAL = {"hidden_size": 32, "intermediate_size": 48,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 8, "num_hidden_layers": 2, "vocab_size": 64,
           "tie_word_embeddings": True, "num_local_experts": 4,
           "num_experts_per_tok": 2}
# sha256 of every drawn tensor (path, shape, dtype, bytes; paths sorted),
# recorded from the harness before the layout moved into the module
DIGESTS = {
    ("yi", "float32"):
        "9ae9199cdb11f14cbda1425b084580ff0dcb47c23f684265ad3d2eee5f0586a9",
    ("yi", "bfloat16"):
        "57ceb1ea974bbd399152615ca7ada4fc263d86d70abcc626cb91948d8bb1f47e",
    ("yi_wide", "float32"):
        "33b08f9beeed1413235c3301e6af239c7d4ae5f8300abec3c4a381f90b58abf6",
    ("yi_wide", "bfloat16"):
        "13bd937e912b7264a6c6c84197b797ec99fed547546e8cd9e0b6790d04f53438",
    ("mixtral", "float32"):
        "129f4a9dea7ef434cc259119879b40f21af7e8ad3794c70a21387e02160c3f28",
    ("mixtral", "bfloat16"):
        "ad6344cde34f5b649061e3d7a1664c59b630e1e6d8b10b20e16927ba92cbbb09",
}
CONFS = {"yi": YI, "yi_wide": YI_WIDE, "mixtral": MIXTRAL}
# sha256 of repr() of yi9b's matrix list (338 entries) and norm paths (97),
# recorded from the same harness
YI9B_LEAVES = \
    "9b397f0c3b56a1e3de5eaf27510009c88df56847de60a6c1e9da68ac8be6c101"
YI9B_NORMS = \
    "186e0a9a2a0d0a3d82a060990cbf8338df9ef04591622f52fa30f386f88b38e1"


class Run:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from flat(v, path + (i,))
    else:
        yield path, tree


def digest(tree) -> str:
    h = hashlib.sha256()
    for path, t in sorted(flat(tree), key=lambda e: repr(e[0])):
        t = t.contiguous()
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        h.update(repr((path, tuple(t.shape), str(t.dtype))).encode())
        h.update(raw.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["yi", "yi_wide", "mixtral"])
def test_llama_draw_is_unchanged(name, dtype):
    p = weights.make_params(llama, CONFS[name], SEED, "cpu",
                            getattr(torch, dtype))
    assert digest(p) == DIGESTS[(name, dtype)]


def test_yi9b_layout_is_unchanged():
    conf = spec.read_json(spec.BENCH / "configs" / "yi9b.json")
    s = llama.sizes(conf)
    assert s == {"D": 4096, "H": 32, "Hk": 4, "Dh": 128, "L": 48, "V": 64000,
                 "F": 11008, "E": 0, "K": 0, "tied": False}
    matrices, norms = llama.layout(conf)
    assert matrices == llama.leaves(s) and len(matrices) == 338
    assert hashlib.sha256(repr(matrices).encode()).hexdigest() == YI9B_LEAVES
    paths = [p for p, _ in norms]
    assert hashlib.sha256(repr(paths).encode()).hexdigest() == YI9B_NORMS
    assert paths == llama.norm_paths(s) and len(paths) == 97
    assert {shape for _, shape in norms} == {(4096,)}


def synthetic_phase() -> Phase:
    ph = Phase(t0=10.0, t1=61.25)
    ph.decode = [Call(0, 1, rows=64, live=60 - i % 5, ctx=50000 + 37 * i,
                      kernel_toks=0) for i in range(300)]
    ph.prefill = [Call(0, 1, rows=4, live=1000 - 3 * i,
                       ctx=2_000_000 + 911 * i, kernel_toks=0)
                  for i in range(40)]
    return ph


@pytest.mark.parametrize("conf,want", [
    (spec.read_json(spec.BENCH / "configs" / "yi9b.json"),
     1.9735083628071912),
    (MIXTRAL, 5.4715338538558285e-05)])
def test_window_mfu_is_unchanged(conf, want):
    """The values the harness gave for this phase before the operation
    count moved into the module, to the last bit."""
    run = Run(phase=synthetic_phase(), sizes=llama.sizes(conf),
              arch=spec.load_arch("llama"), dtype_name="bfloat16", cards=1)
    assert flops.window_mfu(run) == want
    assert spec.load_reader("mfu_decode")(run) == want


@pytest.mark.parametrize("offsets,n_valid,window,want", [
    ([3, 20, 40], [1, 1, 1], 0, 4 + 21 + 41),
    ([3, 20, 40], [1, 1, 1], 16, 4 + 16 + 16),
    ([0, 10], [20, 8], 0, 210 + 116),
    ([0, 10], [20, 8], 16, (136 + 4 * 16) + (81 + 2 * 16)),
    ([5, 0], [0, 0], 16, 0)])
def test_attended_by_hand(offsets, n_valid, window, want):
    assert flops.attended(offsets, n_valid, window) == want


# A sparse-expert decoder with windowed layers, keyed as Qwen-MoE-style
# configurations publish it: its own sizes, layout and operation count
SPARSE_MODULE = '''
"""A sparse-expert decoder: every layer's FFN top-k of E experts of width
Fe; layers marked "sliding_attention" attend at most the window."""

from bench import flops

CONFIG_FIELDS = {"hidden_size": "d_model", "num_hidden_layers": "num_layers",
                 "num_experts": "moe.num_experts",
                 "num_experts_per_tok": "moe.experts_per_token",
                 "moe_intermediate_size": "moe.d_expert"}
PROGRAM_FIELDS = {"frontend": "token"}


def logits(params, conf, seqs, starts, fp8=False):
    raise NotImplementedError


def sizes(conf):
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    return {"D": d, "H": h, "Hk": conf["num_key_value_heads"],
            "Dh": conf["head_dim"], "L": conf["num_hidden_layers"],
            "V": conf["vocab_size"], "E": conf["num_experts"],
            "K": conf["num_experts_per_tok"],
            "Fe": conf["moe_intermediate_size"],
            "W": conf["sliding_window"], "kinds": conf["layer_types"]}


def layout(conf):
    s = sizes(conf)
    D, E, Fe, HD, KD = s["D"], s["E"], s["Fe"], s["H"] * s["Dh"], \\
        s["Hk"] * s["Dh"]
    out = [(("embed", "tok"), (s["V"], D), D, "model"),
           (("embed", "untok"), (s["V"], D), D, "model")]
    for i in range(s["L"]):
        out += [(("layers", i, "wq"), (D, HD), D, "model"),
                (("layers", i, "wk"), (D, KD), D, "model"),
                (("layers", i, "wv"), (D, KD), D, "model"),
                (("layers", i, "wo"), (HD, D), HD, "model"),
                (("layers", i, "moe", "router"), (D, E), D, "float32"),
                (("layers", i, "moe", "wg"), (E, D, Fe), D, "model"),
                (("layers", i, "moe", "wu"), (E, D, Fe), D, "model"),
                (("layers", i, "moe", "wd"), (E, Fe, D), Fe, "model")]
    norms = [(("final_norm",), (D,))] + [
        (("layers", i, k), (D,)) for i in range(s["L"])
        for k in ("ln1", "ln2")]
    return out, norms


def window_ops(s, phase):
    D, HD, KD = s["D"], s["H"] * s["Dh"], s["Hk"] * s["Dh"]
    layer = 2 * D * HD + 2 * D * KD + s["K"] * 3 * D * s["Fe"] + D * s["E"]
    calls = phase.decode + phase.prefill
    toks = sum(c.live for c in calls)
    head = sum(c.live for c in phase.decode) + \\
        sum(c.rows for c in phase.prefill)
    att = 0
    for kind in s["kinds"]:
        w = s["W"] if kind == "sliding_attention" else 0
        att += sum(flops.attended(c.offsets, c.n_valid, w) for c in calls)
    return (2.0 * s["L"] * layer * toks + 4.0 * s["H"] * s["Dh"] * att
            + 2.0 * D * s["V"] * head)
'''
SPARSE_CONFIG = {
    "name": "sparse", "source": "test", "hidden_size": 16,
    "intermediate_size": 40, "moe_intermediate_size": 12,
    "num_experts": 4, "num_experts_per_tok": 2, "num_attention_heads": 2,
    "num_key_value_heads": 1, "head_dim": 8, "num_hidden_layers": 2,
    "vocab_size": 32, "sliding_window": 16,
    "layer_types": ["sliding_attention", "full_attention"],
    "reduced": [], "dtype": "bfloat16", "reference": "sparse_windowed",
    "program": {"arch": "qwen3-moe-235b-a22b",
                "set": {"d_model": 16, "num_layers": 2}},
    "engine": {"backend": "local", "rows": 2, "prefill_chunk": 16}}


def test_an_architecture_added_as_files_is_picked_up(tmp_path):
    """A configuration of another architecture, added as new files (its
    module, its configuration) and new entries of a copy of
    BENCHMARK.json, with no file edited: its weights take its module's
    shapes, and its MFU counts k experts of width Fe and caps the windowed
    layer's lengths at the window."""
    shutil.copytree(spec.BENCH, tmp_path / "bench")
    (tmp_path / "bench" / "reference" / "sparse_windowed.py").write_text(
        SPARSE_MODULE)
    (tmp_path / "bench" / "configs" / "sparse.json").write_text(
        json.dumps(SPARSE_CONFIG))
    added = spec.load_benchmark()
    added["configs"].append({"name": "sparse", "source": "test",
                             "file": "bench/configs/sparse.json",
                             "reduced": [], "why": "test"})
    added["workloads"].append({"name": "sparse.decode_heavy",
                               "config": "sparse",
                               "traffic": "decode_heavy", "chips": 1,
                               "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(added))
    cell = spec.Cell(spec.load_benchmark(tmp_path), "sparse.decode_heavy",
                     root=tmp_path, bench_dir=tmp_path / "bench")
    assert cell.arch.__file__ == str(
        tmp_path / "bench" / "reference" / "sparse_windowed.py")
    conf = cell.config

    p = weights.make_params(cell.arch, conf, SEED, "cpu", torch.bfloat16)
    moe = p["layers"][1]["moe"]
    assert moe["router"].shape == (16, 4)
    assert moe["router"].dtype == torch.float32
    assert moe["wg"].shape == moe["wu"].shape == (4, 16, 12)
    assert moe["wd"].shape == (4, 12, 16) and moe["wd"].dtype == \
        torch.bfloat16
    assert p["layers"][0]["wq"].shape == (16, 16)
    assert p["final_norm"].shape == (16,) and "wg" not in p["layers"][0]
    # the same rule as every architecture: one draw a (fan-in, dtype)
    std = float(torch.cat([moe["wg"].float().flatten(),
                           moe["wu"].float().flatten()]).std())
    assert abs(std * 4.0 - 1.0) < 0.1

    # a decode call with live rows at positions 3, 20, 40, and a prefill
    # chunk of two rows: 20 tokens from 0, 8 tokens from 10
    ph = Phase(t0=0.0, t1=2.0)
    ph.decode = [Call(0, 1, rows=4, live=3, ctx=66, kernel_toks=0,
                      offsets=np.array([3, 20, 40]),
                      n_valid=np.array([1, 1, 1]))]
    ph.prefill = [Call(0, 1, rows=2, live=28, ctx=326, kernel_toks=0,
                       offsets=np.array([0, 10]), n_valid=np.array([20, 8]))]
    s = cell.arch.sizes(conf)
    run = Run(phase=ph, sizes=s, arch=cell.arch, dtype_name="bfloat16",
              cards=1)
    # a layer: attention 16*16 + 2*16*8 + 16*16 = 768, two experts of
    # width 12 (not the dense 40) 2*3*16*12 = 1152, the router 16*4 = 64;
    # lengths attended: the full layer 66 + 210 + 116 = 392, the windowed
    # one capped at 16: (4 + 16 + 16) + (136 + 64) + (81 + 32) = 349
    layers = 2 * (768 + 1152 + 64)
    ops = 2 * layers * 31 + 4 * 2 * 8 * (392 + 349) + 2 * 16 * 32 * 5
    assert ops == 298_560
    want = 100.0 * ops / (2.0 * 989e12)
    assert spec.load_reader("mfu_decode", cell.bench_dir)(run) == \
        pytest.approx(want, rel=1e-12)

    # the published keys the module maps, nested fields included, are
    # checked against the port's config; the unused dense width is not
    with pytest.raises(ValueError) as err:
        serve.program_config(cell.arch, conf)
    msg = str(err.value)
    for key in ("'num_experts'", "'moe_intermediate_size'"):
        assert key in msg
    assert "'intermediate_size'" not in msg and "'hidden_size'" not in msg


def test_calls_carry_their_extents(tmp_path):
    """The wrappers' offsets and n_valid give back each call's real tokens
    and summed lengths, on the tiny cell's served path."""
    cell = tiny.tiny_cell(tmp_path)
    runner = serve.Runner(cell, SEED, "cpu")
    runner.warm_up()
    ph = runner.run_phase(1.0)
    runner.free_engine()
    assert ph.decode and ph.prefill
    for c in ph.decode + ph.prefill:
        assert int(np.sum(c.n_valid)) == c.live
        assert flops.attended(c.offsets, c.n_valid) == c.ctx
    for c in ph.decode:
        assert set(c.n_valid.tolist()) == {1}
        assert flops.attended(c.offsets, c.n_valid, 8) == \
            int(np.minimum(c.offsets + 1, 8).sum())


HARNESS_WORDS = re.compile(r"llama|mixtral|phimoe|qwen|gemma|yi-9b|moe|"
                           r"expert|intermediate_size", re.IGNORECASE)


def test_no_harness_file_names_an_architecture():
    files = sorted(spec.BENCH.glob("*.py")) + \
        sorted((spec.BENCH / "metrics").glob("*.py"))
    named = {f.name: HARNESS_WORDS.findall(f.read_text()) for f in files}
    assert not {k: v for k, v in named.items() if v}
