"""The plain reference against the port's model on the CPU, float32 on
both sides: an exact-length prefill and decode steps through a cache."""

import numpy as np
import torch

from bench import serve, weights
from bench.reference import llama as ref
from bench.tests import tiny


def test_reference_matches_the_port_prefill_and_decode():
    from repro_torch.models import model as M
    from repro_torch.models.common import Runtime

    conf = dict(tiny.TINY_CONFIG)
    cfg = serve.program_config(ref, conf)
    params = weights.make_params(ref, conf, 2**31 + 11, "cpu", torch.float32)
    rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 256, size=37).tolist()
    with torch.no_grad():
        last, caches = M.prefill(params, {"tokens": torch.tensor([prompt])},
                                 cfg, rt, capacity=64)
        got = [last[0]]
        seq = list(prompt)
        for _ in range(6):
            tok = int(got[-1].argmax())
            seq.append(tok)
            logits, caches = M.decode_step(
                params, torch.tensor([tok]), caches,
                torch.tensor([len(seq) - 1]), cfg, rt)
            got.append(logits[0])
    want = ref.logits(params, conf, [seq], [len(prompt) - 1])[0]
    assert want.shape == (7, 256)
    assert torch.allclose(torch.stack(got), want, atol=2e-5, rtol=1e-5)


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(64, 128, generator=torch.Generator().manual_seed(0))
    e8 = (ref.to_fp8(x, -1) - x).abs().mean()
    e16 = (x.to(torch.bfloat16).float() - x).abs().mean()
    assert e8 > 8 * e16
