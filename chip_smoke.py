#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. the build: every ``src/repro_torch/kernels/csrc/*.cu`` compiled with
   ``nvcc``, one process per source, all started together (paged
   attention, flash attention, the RG-LRU scan), with each library's count
   of ``HGMMA`` (wgmma), ``UTMALDG`` / ``UTMASTG`` (TMA loads and stores),
   ``LDGSTS`` (cp.async) and ``HMMA`` (mma.sync) instructions from
   ``cuobjdump -sass``;
3. the paged decode kernel against its plain PyTorch version on the card,
   at the main paths' shapes (yi-9b: B=16, H=32, Hk=4, Dh=128, page 16, up
   to 2048 tokens, a zero-length row, NaN in every page no row owns;
   gemma3-12b's global layers: B=16, H=16, Hk=8, Dh=256, up to 2080
   tokens) in bf16 (within one bf16 ulp: ``rtol = 2**-7``, ``atol =
   1e-5``) and float32 (``atol = rtol = 1e-5``), a sliding window, the yi-9b
   serve phase's own batch, table and pool shapes, a sweep of G, Dh and
   page size, page ids outside the pool, and the split-KV edges (lengths
   at a split boundary and one token either side, one row far longer than
   the rest); then times: kernel (with its TB/s and the previous design's
   time), plain version, ``scaled_dot_product_attention`` over the
   gathered KV (a yardstick the port never calls) and the least time the
   card could take;
4. the flash-attention kernel against its plain version at gemma3-12b's
   prefill shapes (B=1, H=16, Hk=8, Dh=256, S from 8 to 2048, causal, with
   and without the 1024-token window), a sweep of Dh, G, non-causal and
   Sq != Skv, the bf16 kernel's tile edges (Sq, Skv in 127, 128, 129 at
   G = 1 and 16), bf16 and float32 with the same tolerances, every K/V the
   first Skv rows of a tensor whose tail is NaN; then the same four times
   (the kernel's with its TFLOP/s and the previous design's time);
   and at recurrentgemma-9b's local layers (B=1, H=16 over one kv head:
   G=16, Dh=256, causal, window 2048, S from 8 to 4096), with its times;
5. the RG-LRU scan kernel against its plain version (a float32 loop over
   time) at recurrentgemma-9b's prefill shapes (B=1, Dr=4096, S in 8, 100
   and the buckets 1024, 2048, 4096, random h0) and a sweep of B in
   {1, 3}, Dr in {128, 4000}, S=257, with and without h0, every input the
   front of a buffer whose tail is NaN; both round each step's multiply
   and add once, so they must agree exactly (``atol = rtol = 0``); then
   kernel, plain and bound times at each bucket, cold L2 (no single
   PyTorch call computes the recurrence, so no library time), beside the
   previous design's and that of ``a + b`` (not the recurrence, but the
   same bytes moved: what the memory gives this traffic), and the host
   time of one wrapper call at S=1024;
5b. both attention kernels at group sizes they are not built for
   (``kernels.groups``: the paged kernel at G = 3, 6 and 16, the flash
   kernel at G = 3 and 6) against their plain versions, and timed beside
   G = 4 and 8;
6. end-to-end parity, float32, served by the port on the CPU (plain path)
   and on the card (kernel path), greedy streams identical: a 2-layer model
   with yi-9b's head layout (chunked prefill, paged kernel), the same with
   global pools swapped by the offloader at N_B = 4 (equal swap counts on
   both devices), a 4-layer
   ``(local, global)`` model at head_dim 64 with a 32-token window (exact
   prefill through the flash kernel, rings, paged kernel), and a 4-layer
   ``(rglru, rglru, local)`` model at head_dim 64 (16 heads over one kv
   head) with a 32-token window (the scan and flash kernels, recurrent
   states, rings); prompts past the window, more requests than slots;
7. the yi-9b serve phase: ``repro_torch.serving.llm.LLM`` on full-width,
   full-depth yi-9b in bf16 with random weights from the seed, 20 requests
   of 64-768 prompt tokens and 32 new tokens, greedy and sampled mixed;
   every request must finish at full length with finite log-probs, and the
   paged kernel's launch count must equal decode ticks x 48;
   then, on the same weights and requests, the offloaded serve (4 x 4
   slots, 400 local pages and two global pools of 400 swapped through
   pinned host memory on the offloader's copy stream, beside an engine of
   1,200 local pages: every stream equal token for token, the swap books
   as the swaps imply, at least a quarter of the requests in global
   pages, no allocation refused) and the planned serve (the card's pinned
   copy rate and a measured stage time through ``EngineConfig.plan``,
   Formula 1's per-microbatch capacity printed beside the allocator's);
8. the gemma3 serve phase: full-width, full-depth gemma3-12b in bf16 (48
   layers, 5 local : 1 global), 20 requests of 256-2048 prompt tokens, 32
   new tokens each; ``prefill_mode="auto"`` must pick exact-length
   prefill, every request must finish at full length with finite
   log-probs, the flash kernel must run 20 x 48 times and the paged kernel
   decode ticks x 8 times;
9. the recurrentgemma serve phase: full-width, full-depth
   recurrentgemma-9b in bf16 (38 layers: 26 rglru, 12 local with a
   2,048-token window), 20 requests of 256-3072 prompt tokens bucketed to
   powers of two, 32 new tokens each; exact-length prefill, every request
   at full length with finite log-probs, the scan kernel 20 x 26 times,
   the flash kernel 20 x 12 times, the paged kernel never; it prints how
   many in-window tokens the rings lost to the reference's padded-ring
   behaviour (ROADMAP Queue 3).

6b. the offloader's stream ordering at yi-9b's full-width pools (48 bf16
   layers, two global pools of 128 pages, N_B = 4, 8 rounds): after each
   swap the compute stream reads the resident slice and runs one paged
   launch over it, exactly against a reference copy, then writes a fresh
   signature, with no synchronisation until the end.

Each serve phase sets every kernel's launch count to 0 just before it
drives its path and reads them just after; the kernels line reports those
counts by path.

It prints an ``{"offload": ...}`` line (swap books, copy and wait times,
the planner's inputs), a ``{"kernels": [...]}`` line, the card's
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  It exits non-zero without a
result when no CUDA device is visible.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
HBM_BYTES_PER_S = 3.35e12             # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,     # dense tensor-core bf16
              "float32": 67e12}       # float32 outside the tensor cores
YI_LAYERS = 48
KERNELS = ("paged_attention", "flash_attention", "rglru_scan")
# kernel against plain version, (atol, rtol).  Both compute in float32 and
# round once to the output dtype, so bf16 outputs differ by at most one
# bf16 ulp (2**-7 of the value) where the float32 results straddle a
# rounding boundary; atol covers float32 summation order near zero.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2 ** -7)}
# the serve phase: batch, pool and traffic (phase 3 also checks the kernel
# at exactly these shapes)
SERVE_MB, SERVE_N_MB, SERVE_PAGE, SERVE_MAX_PAGES = 16, 1, 16, 64
SERVE_POOL_PAGES = SERVE_MB * SERVE_N_MB * SERVE_MAX_PAGES + 1
SERVE_REQUESTS, SERVE_PROMPTS, SERVE_NEW = 20, (64, 768), 32
# the gemma3-12b serve phase (phases 3 and 4 check the kernels at its
# decode and prefill shapes)
GEMMA_MB, GEMMA_PAGE, GEMMA_MAX_PAGES = 16, 16, 136        # 2,176 tokens
GEMMA_POOL_PAGES = GEMMA_MB * GEMMA_MAX_PAGES + 1
GEMMA_REQUESTS, GEMMA_PROMPTS, GEMMA_NEW = 20, (256, 2048), 32
FLASH_LENGTHS = (8, 100, 1023, 1024, 1500, 2048)
# the recurrentgemma-9b serve phase (phases 4 and 5 check the flash kernel
# at G = 16 and the scan kernel at its prefill shapes)
RG_MB, RG_PAGE, RG_MAX_PAGES = 16, 16, 196                 # 3,136 tokens
RG_POOL_PAGES = RG_MB * RG_MAX_PAGES + 1
RG_REQUESTS, RG_PROMPTS, RG_NEW = 20, (256, 3072), 32
RG_FLASH_LENGTHS = (8, 100, 1500, 2048, 2049, 4096)   # power-of-two buckets
SCAN_BUCKETS = (1024, 2048, 4096)     # the prefill buckets, each timed
SCAN_LENGTHS = (8, 100) + SCAN_BUCKETS                  # and ragged lengths
SCAN_TOL = 0        # atol = rtol; the kernel and plain loop round alike
# the previous designs' times at the timed shapes (the mma.sync flash
# kernel and the one-block-a-pair paged kernel, PERF.md section 6; the
# one-thread-a-channel scan, timed by this script's scan phase on the
# tree that still had it, cold L2), all on an NVIDIA H100 80GB HBM3 at
# 700 W, printed beside this run's
PREV_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PREV_MS = {"paged yi-9b": 0.1784, "paged gemma3-12b": 0.1656,
           "flash causal": 0.4778, "flash window 1024": 0.3868,
           "flash recurrentgemma": 1.0455,
           "scan 1024": 0.0719, "scan 2048": 0.1328, "scan 4096": 0.2549}
# instructions counted in each library's SASS: wgmma, TMA loads and
# stores, cp.async and mma.sync
SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "LDGSTS", "HMMA")
# group sizes the kernels are not built for (zero-padded groups, and the
# paged kernel's G = 16 as two launches of 8), checked and timed beside
# the built ones
PAGED_GROUPS = (3, 4, 6, 8, 16)
FLASH_GROUPS = (3, 4, 6, 8)
GROUP_SPIN_CYCLES = 2_000_000       # about 1 ms: the host issues a whole
                                    # regrouped call before its span starts
# the swap-ordering phase: yi-9b's 48 bf16 layer pools with two global
# pools of 128 pages (1,572,864 bytes a page across the layers), N_B = 4
# microbatches visited round robin; before each signature write the
# compute stream spins, so a copy that ignored its event would read or
# write early
SWAP_PAGE, SWAP_LOCAL, SWAP_GLOBAL, SWAP_MBS, SWAP_ROUNDS = 16, 64, 128, 4, 8
SWAP_SPIN_CYCLES = 4_000_000
# the offloaded yi-9b serve: the yi-9b phase's 20 requests over 4 x 4
# slots; 400 local pages and two global pools of 400 (about a third of the
# requests overflow into a global pool, none ever waits for pages), beside
# an engine of 1,200 local pages on the same weights
OFF_MB, OFF_N_MB, OFF_LOCAL, OFF_GLOBAL, OFF_BASE_LOCAL = 4, 4, 400, 400, 1200
# the planned yi-9b serve (EngineConfig.plan): its inputs, and the pinned
# host store it may imply before the KV budget is lowered
PLAN_STAGES, PLAN_LATENCY, PLAN_KV_BYTES = 2, 0.064, 4 * 2 ** 30
PLAN_MAX_HOST_BYTES = 8 * 2 ** 30
PLAN_COPY_BYTES = 256 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters: int, flush=None, spin: int = 0) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, by CUDA events
    around each launch; ``flush`` runs between launches, outside the
    timed spans (cold L2, as a layer's own pool is on the main path).
    ``spin`` (GPU clock cycles) keeps the card busy before each span so
    that the host has issued all of ``fn``'s launches before the span
    starts: the span is then the device's work alone, without the gaps
    where it waits for the host."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        if flush is not None:
            flush()
        if spin:
            torch.cuda._sleep(spin)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def _counted():
    """Each kernel wrapper, by kernel; ``.launches`` is its count."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rglru_scan as rs
    return {"paged_attention": pa.paged_decode_attention,
            "flash_attention": fa.flash_attention,
            "rglru_scan": rs.rglru_scan}


def reset_counts() -> None:
    for fn in _counted().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counted().items()}


# ---------------------------------------------------------------------------
# paged attention inputs
# ---------------------------------------------------------------------------


def paged_case(torch, np, rng, *, b, h, hk, dh, page, max_pages, lens,
               dtype, device, pool_pages=0):
    """Random pools (at least ``pool_pages`` pages) where each row owns its
    own pages, unused table slots point at foreign pages, and every slot no
    row's tokens occupy holds NaN (foreign pages and the tail of each row's
    last page)."""
    lens = np.asarray(lens, np.int32)
    need = [-(-int(n) // page) for n in lens]
    n_pool = max(pool_pages, 1 + sum(need) + 2)
    perm = rng.permutation(np.arange(1, 1 + sum(need)))
    kp = torch.randn((n_pool, page, hk, dh), device=device)
    vp = torch.randn((n_pool, page, hk, dh), device=device)
    valid = torch.zeros((n_pool, page), dtype=torch.bool, device=device)
    pt = np.zeros((b, max_pages), np.int32)
    at = 0
    for r in range(b):
        own = list(perm[at:at + need[r]])
        at += need[r]
        pt[r] = own + [n_pool - 1 - (r + j) % 2
                       for j in range(max_pages - len(own))]
        for j, p in enumerate(own):
            valid[p, :min(page, int(lens[r]) - j * page)] = True
    kp[~valid] = float("nan")
    vp[~valid] = float("nan")
    q = torch.randn((b, h, dh), device=device)
    return (q.to(dtype), kp.to(dtype), vp.to(dtype),
            torch.from_numpy(pt).to(device), torch.from_numpy(lens).to(device))


def bound(case_lens, window, h, hk, dh, esize, dtype_name, b, max_pages):
    """Least time for the work: K and V rows each read once for the tokens
    attended, q / table / lengths read once, out written once; and the
    flops 4 * H * Dh per token over the peak rate of the dtype.  Returns
    (ms, what bounds it, bytes)."""
    toks = sum(min(int(n), window) if window else int(n) for n in case_lens)
    nbytes = toks * hk * dh * 2 * esize + 2 * b * h * dh * esize \
        + b * max_pages * 4 + b * 4
    flops = 4 * h * dh * toks
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def paged_sdpa(torch, q, kp, vp, pt, sl):
    """The yardstick for a paged decode: one SDPA call over the KV gathered
    into contiguous (B, Hk, C, Dh) tensors with a length mask (the gather
    is made here, outside the timed call)."""
    b, c = pt.shape[0], pt.shape[1] * kp.shape[1]
    hk, dh = kp.shape[2], kp.shape[3]
    pos = torch.arange(c, device=q.device)
    mask = (pos[None] < sl[:, None].long())[:, None, None, :]
    kg, vg = (torch.nan_to_num(t[pt.long()].reshape(b, c, hk, dh)).transpose(
        1, 2).contiguous() for t in (kp, vp))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q[:, :, None, :], kg, vg, attn_mask=mask,
                        enable_gqa=True)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_card(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    line = smi.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device 0: {name}; devices visible: {torch.cuda.device_count()}")
    log(f"[card] nvidia-smi: {line}")
    return line, name


def sass_counts(path) -> dict:
    """How many of each of ``SASS_OPS`` the library's SASS holds, by
    ``cuobjdump -sass`` from ``$CUDA_HOME/bin``; None when the tool is
    absent or fails (the counts report the design, they decide nothing)."""
    import os
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                "cuobjdump")
    if not tool.exists():
        return None
    res = subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        return None
    ops = []
    for ln in res.stdout.splitlines():
        words = ln.split()      # /*1a90*/ [@P0] OPCODE.MODIFIERS ...
        if len(words) > 2 and re.fullmatch(r"/\*[0-9a-f]+\*/", words[0]):
            op = words[2] if words[1].startswith("@") else words[1]
            ops.append(op.split(".")[0])
    return {op: ops.count(op) for op in SASS_OPS}


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    infos = build.build_many(KERNELS)
    wall = time.perf_counter() - t0
    sass = {}
    for name in KERNELS:
        info = infos[name]
        regs = [ln.strip() for ln in info.log.splitlines()
                if "registers" in ln]
        spills = sum(1 for ln in info.log.splitlines()
                     if "spill stores" in ln
                     and " 0 bytes spill stores" not in ln)
        log(f"[build] {name}: {info.seconds:.2f}s nvcc"
            f"{' (cached)' if info.cached else ''} -> {info.path.name}; "
            f"{len(regs)} kernel instances ({spills} with spills), e.g. "
            f"{regs[-1] if regs else '-'}")
        build.load(name)
        sass[name] = sass_counts(info.path)
        log(f"[build] {name} SASS: " + (
            ", ".join(f"{op} {n}" for op, n in sass[name].items())
            if sass[name] is not None else
            "cuobjdump absent from $CUDA_HOME/bin, not counted"))
    log(f"[build] {len(KERNELS)} sources in parallel: {wall:.2f}s wall")
    return sass


def phase_kernel_paged(torch, np):
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED)
    torch.manual_seed(SEED)

    def check(label, args, window):
        atol, rtol = TOL[str(args[0].dtype).split(".")[-1]]
        got = pa.paged_decode_attention(*args, window=window)
        torch.cuda.synchronize()
        want = ref.paged_decode_attention_ref(*args, window=window)
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{label}: non-finite kernel output")
        zero = args[4] == 0
        if not (got[zero] == 0).all():
            raise AssertionError(f"{label}: a seq_len == 0 row is not zeros")
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol, msg=lambda m: f"{label}: {m}")
        log(f"[kernel] {label}: max |kernel - plain| = {err:.3e} "
            f"(atol {atol:g}, rtol {rtol:g}) ok")
        return err

    # the main path's shapes: yi-9b heads, 16 rows, up to 2048 tokens
    B, H, HK, DH, PAGE, MAXP = 16, 32, 4, 128, 16, 128
    lens = rng.randint(1, MAXP * PAGE + 1, B)
    lens[1], lens[5] = MAXP * PAGE, 0
    main = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = paged_case(torch, np, rng, b=B, h=H, hk=HK, dh=DH, page=PAGE,
                          max_pages=MAXP, lens=lens, dtype=dtype, device=dev)
        name = str(dtype).split(".")[-1]
        main[name] = (args, check(f"yi-9b shapes {name}", args, 0))
        check(f"yi-9b shapes {name} window=500", args, 500)
        # the serve phase's own shapes: its batch, table width and pool,
        # its context lengths, and an idle row (1 token on scratch page 0)
        sl = rng.randint(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + SERVE_NEW + 1,
                         SERVE_MB)
        sl[3] = 0
        args = paged_case(torch, np, rng, b=SERVE_MB, h=H, hk=HK, dh=DH,
                          page=SERVE_PAGE, max_pages=SERVE_MAX_PAGES,
                          lens=sl, dtype=dtype, device=dev,
                          pool_pages=SERVE_POOL_PAGES)
        q, kp, vp, pt, sl = args
        pt[7], sl[7] = 0, 1
        kp[0, 0], vp[0, 0] = torch.randn((2, HK, DH), device=dev).to(dtype)
        check(f"serve-phase shapes {name} (table {tuple(pt.shape)}, pool "
              f"{tuple(kp.shape)})", args, 0)
    # gemma3-12b's global layers at its serve phase's decode shape: 16
    # rows, 16 heads over 8 kv heads of 256, table 136 pages, up to 2,080
    # tokens (2,048 of prompt + 32 new)
    gl = rng.randint(GEMMA_PROMPTS[0], GEMMA_PROMPTS[1] + GEMMA_NEW + 1,
                     GEMMA_MB)
    gl[2] = GEMMA_PROMPTS[1] + GEMMA_NEW
    gemma = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = paged_case(torch, np, rng, b=GEMMA_MB, h=16, hk=8, dh=256,
                          page=GEMMA_PAGE, max_pages=GEMMA_MAX_PAGES,
                          lens=gl, dtype=dtype, device=dev)
        name = str(dtype).split(".")[-1]
        gemma[name] = args
        check(f"gemma3-12b decode shapes {name}", args, 0)
    for g in (1, 2, 4, 8):
        for dh in (64, 128, 256):
            for page in (8, 16, 32):
                sl = rng.randint(1, 8 * page + 1, 4)
                sl[2] = 0
                for dtype in (torch.float32, torch.bfloat16):
                    args = paged_case(torch, np, rng, b=4, h=2 * g, hk=2,
                                      dh=dh, page=page, max_pages=8, lens=sl,
                                      dtype=dtype, device=dev)
                    win = 0 if page == 16 else page + 3
                    check(f"sweep G={g} Dh={dh} page={page} "
                          f"{str(dtype).split('.')[-1]} window={win}",
                          args, win)

    # page ids out of the pool clamp to [0, P-1], as the TPU kernel's
    # wrapper clamps them (clean pools: a clamped id may land anywhere)
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, pt, sl = paged_case(torch, np, rng, b=4, h=16, hk=2,
                                       dh=128, page=16, max_pages=6,
                                       lens=[70, 96, 33, 5], dtype=dtype,
                                       device=dev)
        kp, vp = torch.nan_to_num(kp), torch.nan_to_num(vp)
        pt[0, 1], pt[1, 0], pt[2, 2] = kp.shape[0] + 5, -4, 10 ** 6
        check(f"clamped page ids {str(dtype).split('.')[-1]}",
              (q, kp, vp, pt, sl), 0)

    # split-KV edges at the yi-9b shape: lengths at a split boundary and one
    # token either side, and one row far longer than the rest (the other
    # rows' later splits are empty)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    pages, n_split = pa.split_plan(MAXP, PAGE, B * HK, n_sm)
    span = pages * PAGE
    at_edges = [span - 1, span, span + 1, 2 * span - 1, 2 * span,
                2 * span + 1, 0, MAXP * PAGE, MAXP * PAGE - 1, 1, 3 * span,
                3 * span + 1, 5, span // 2, (n_split - 1) * span - 1,
                (n_split - 1) * span + 1]
    one_long = [MAXP * PAGE] + list(rng.randint(1, 41, B - 1))
    for label, lens_e in (("at split boundaries", at_edges),
                          ("one long row", one_long)):
        for dtype in (torch.bfloat16, torch.float32):
            args = paged_case(torch, np, rng, b=B, h=H, hk=HK, dh=DH,
                              page=PAGE, max_pages=MAXP, lens=lens_e,
                              dtype=dtype, device=dev)
            for win in (0, span // 2 + 3):
                check(f"split-KV {label} ({n_split} splits of {pages} "
                      f"pages) {str(dtype).split('.')[-1]} window={win}",
                      args, win)

    # times at the main shape, bf16 (the serve phase's dtype)
    args, err = main["bfloat16"]
    q, kp, vp, pt, sl = args
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    ms = time_ms(torch, lambda: pa.paged_decode_attention(q, kp, vp, pt, sl),
                 50, flush)
    plain_ms = time_ms(torch, lambda: ref.paged_decode_attention_ref(
        q, kp, vp, pt, sl), 20, flush)
    library_ms = time_ms(torch, paged_sdpa(torch, q, kp, vp, pt, sl), 50,
                         flush)
    bound_ms, bound_by, nbytes = bound(sl.tolist(), 0, H, HK, DH, 2,
                                       "bfloat16", B, MAXP)
    log(f"[kernel] times at B={B} H={H} Hk={HK} Dh={DH} page={PAGE} "
        f"tokens={int(sl.sum())} bf16, cold L2: kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms(sdpa)={library_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}); "
        f"kernel at {bound_ms / ms:.1%} of the bound, "
        f"{nbytes / ms / 1e9:.3f} TB/s; previous design "
        f"{PREV_MS['paged yi-9b']:.4f} ms on {PREV_CARD}")

    # the same four times at gemma3-12b's decode shape
    q, kp, vp, pt, sl = gemma["bfloat16"]
    c = GEMMA_MAX_PAGES * GEMMA_PAGE
    g_ms = time_ms(torch, lambda: pa.paged_decode_attention(q, kp, vp, pt,
                                                            sl), 50, flush)
    g_plain = time_ms(torch, lambda: ref.paged_decode_attention_ref(
        q, kp, vp, pt, sl), 20, flush)
    g_lib = time_ms(torch, paged_sdpa(torch, q, kp, vp, pt, sl), 50, flush)
    g_bound, g_by, g_bytes = bound(sl.tolist(), 0, 16, 8, 256, 2,
                                   "bfloat16", GEMMA_MB, GEMMA_MAX_PAGES)
    log(f"[kernel] times at gemma3-12b decode B={GEMMA_MB} H=16 Hk=8 "
        f"Dh=256 page={GEMMA_PAGE} tokens={int(sl.sum())} bf16, cold L2: "
        f"kernel_ms={g_ms:.4f} plain_ms={g_plain:.4f} "
        f"library_ms(sdpa)={g_lib:.4f} bound_ms={g_bound:.4f} ({g_by}); "
        f"kernel at {g_bound / g_ms:.1%} of the bound, "
        f"{g_bytes / g_ms / 1e9:.3f} TB/s; previous design "
        f"{PREV_MS['paged gemma3-12b']:.4f} ms on {PREV_CARD}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "gemma3_decode": {"ms": g_ms, "plain_ms": g_plain,
                              "bound_ms": g_bound, "bound_by": g_by,
                              "library_ms": g_lib}}


def flash_bound(sq, skv, causal, window, h, hk, dh, esize, dtype_name):
    """Least time for the work: the live (query, key) pairs cost 4 * Dh
    flops a head over the peak rate of the dtype; q, k, v read once and the
    output written once over the memory rate.  The larger wins.  Returns
    (ms, what bounds it, flops)."""
    live = 0                                  # visible (query, key) pairs
    for i in range(sq):
        hi = min(i, skv - 1) if causal else skv - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        live += max(0, hi - lo + 1)
    flops = 4 * dh * h * live
    nbytes = (2 * sq * h * dh + 2 * skv * hk * dh) * esize
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops


def phase_kernel_flash(torch, np):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    torch.manual_seed(SEED + 2)

    def case(b, sq, skv, h, hk, dh, dtype):
        """q, and k/v as the first Skv rows of (B, Skv + 64, Hk, Dh)
        tensors whose tail is NaN: a read past Skv reaches the output.
        (At B = 1 the slices are contiguous, as the kernel needs.)"""
        q = torch.randn((b, sq, h, dh), device=dev).to(dtype)
        kv = []
        for _ in range(2):
            big = torch.randn((b, skv + 64, hk, dh), device=dev)
            big[:, skv:] = float("nan")
            kv.append(big.to(dtype)[:, :skv])
        return q, kv[0], kv[1]

    def check(label, args, causal, window):
        name = str(args[0].dtype).split(".")[-1]
        atol, rtol = TOL[name]
        got = fa.flash_attention(*args, causal=causal, window=window)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(*args, causal=causal, window=window)
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{label}: non-finite kernel output")
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol, msg=lambda m: f"{label}: {m}")
        log(f"[flash] {label} {name}: max |kernel - plain| = {err:.3e} "
            f"(atol {atol:g}, rtol {rtol:g}) ok")
        return err

    # gemma3-12b prefill: 16 heads over 8 kv heads of 256, the global
    # layers' causal attention and the local layers' 1024-token window
    main = {}
    for dtype in (torch.bfloat16, torch.float32):
        for s_len in FLASH_LENGTHS:
            args = case(1, s_len, s_len, 16, 8, 256, dtype)
            for window in (0, 1024):
                err = check(f"gemma3-12b prefill S={s_len} causal "
                            f"window={window}", args, True, window)
                if s_len == FLASH_LENGTHS[-1] and dtype == torch.bfloat16:
                    main[window] = (args, err)
    # every head dim and group size, non-causal, Sq != Skv both ways
    for dh in (64, 128, 256):
        for g in (1, 2, 4, 8):
            for dtype in (torch.float32, torch.bfloat16):
                sq, skv = (77, 130) if g % 2 else (130, 77)
                check(f"sweep Dh={dh} G={g} Sq={sq} Skv={skv} non-causal",
                      case(1, sq, skv, 2 * g, 2, dh, dtype), False, 0)
                check(f"sweep Dh={dh} G={g} Sq={skv} Skv={sq} causal "
                      "window=37", case(1, skv, sq, 2 * g, 2, dh, dtype),
                      True, 37)

    # recurrentgemma-9b's local layers: 16 heads over one kv head of 256
    # (G = 16: a block holds 4 query positions x 16 heads), causal, window
    # 2048, at the power-of-two prefill buckets and lengths around them
    rg = {}
    for dtype in (torch.bfloat16, torch.float32):
        for s_len in RG_FLASH_LENGTHS:
            args = case(1, s_len, s_len, 16, 1, 256, dtype)
            err = check(f"recurrentgemma-9b prefill G=16 S={s_len} causal "
                        "window=2048", args, True, 2048)
            if s_len == RG_FLASH_LENGTHS[-1] and dtype == torch.bfloat16:
                rg = {"args": args, "err": err}
    for dh in (64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            check(f"sweep Dh={dh} G=16 Sq=77 Skv=130 non-causal",
                  case(1, 77, 130, 16, 1, dh, dtype), False, 0)

    # the bf16 kernel's tile edges: 128 score rows a block (128 / G
    # positions), 64 keys a kv tile; Sq and Skv one short of a tile,
    # exactly a tile, and one over, at G = 1 and G = 16
    for g, hk, dh in ((1, 2, 128), (16, 1, 256)):
        for sq in (127, 128, 129):
            for skv in (127, 128, 129):
                for dtype in (torch.bfloat16, torch.float32):
                    args = case(1, sq, skv, g * hk, hk, dh, dtype)
                    for causal, window in ((True, 0), (False, 0),
                                           (True, 50)):
                        check(f"tile edge G={g} Dh={dh} Sq={sq} Skv={skv} "
                              f"causal={causal} window={window}", args,
                              causal, window)

    # times at S = 2048, bf16, for both layer kinds (warm L2: a prefill
    # layer has just written its q, k, v)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = {}
    for window in (0, 1024):
        (q, k, v), err = main[window]
        s_len = q.shape[1]
        ms = time_ms(torch, lambda: fa.flash_attention(
            q, k, v, causal=True, window=window), 20)
        plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(
            q, k, v, causal=True, window=window), 5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if window:
            i = torch.arange(s_len, device=dev)
            band = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
            lib = lambda: sdpa(qt, kt, vt, attn_mask=band, enable_gqa=True)
        else:
            lib = lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        library_ms = time_ms(torch, lib, 20)
        bound_ms, bound_by, flops = flash_bound(s_len, s_len, True, window,
                                                16, 8, 256, 2, "bfloat16")
        prev = PREV_MS["flash window 1024" if window else "flash causal"]
        log(f"[flash] times at gemma3-12b prefill B=1 S={s_len} H=16 Hk=8 "
            f"Dh=256 causal window={window} bf16: kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms(sdpa)={library_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}); kernel at "
            f"{bound_ms / ms:.1%} of the bound, "
            f"{flops / ms / 1e9:.1f} TFLOP/s; previous design {prev:.4f} "
            f"ms on {PREV_CARD}")
        times[window] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": library_ms}
    # the same four times at recurrentgemma-9b's longest prefill bucket
    q, k, v = rg["args"]
    s_len, window = q.shape[1], 2048
    ms = time_ms(torch, lambda: fa.flash_attention(
        q, k, v, causal=True, window=window), 20)
    plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(
        q, k, v, causal=True, window=window), 3)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    i = torch.arange(s_len, device=dev)
    band = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
    library_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=band,
                                             enable_gqa=True), 20)
    bound_ms, bound_by, flops = flash_bound(s_len, s_len, True, window, 16,
                                            1, 256, 2, "bfloat16")
    log(f"[flash] times at recurrentgemma-9b prefill B=1 S={s_len} H=16 "
        f"Hk=1 Dh=256 causal window={window} bf16: kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms(sdpa, band mask)="
        f"{library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}); kernel at "
        f"{bound_ms / ms:.1%} of the bound, {flops / ms / 1e9:.1f} TFLOP/s; "
        f"previous design {PREV_MS['flash recurrentgemma']:.4f} ms on "
        f"{PREV_CARD}")
    rg_times = {"max_abs_err": rg["err"], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}
    return {**times[0], "window_1024": times[1024],
            "recurrentgemma_prefill": rg_times}


def phase_kernel_scan(torch, np):
    """The RG-LRU scan kernel against its plain loop, exactly."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rs
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)

    def nan_tailed(shape, fill):
        """A float32 tensor of ``shape`` at the front of a buffer whose
        tail is NaN: a read past its end reaches the output."""
        n = math.prod(shape)
        buf = torch.full((n + 4096,), float("nan"), device=dev)
        buf[:n] = fill(n)
        return buf[:n].view(shape)

    def case(b, s_len, dr, with_h0):
        a = nan_tailed((b, s_len, dr), lambda n: torch.sigmoid(
            torch.randn(n, generator=gen, device=dev)))
        bb = nan_tailed((b, s_len, dr), lambda n: torch.randn(
            n, generator=gen, device=dev))
        h0 = nan_tailed((b, dr), lambda n: torch.randn(
            n, generator=gen, device=dev)) if with_h0 else None
        return a, bb, h0

    def check(label, args):
        got = rs.rglru_scan(*args)
        torch.cuda.synchronize()
        want = ref.rglru_scan_ref(*args)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: non-finite kernel output")
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=SCAN_TOL, atol=SCAN_TOL,
                                   msg=lambda m: f"{label}: {m}")
        log(f"[scan] {label}: max |kernel - plain| = {err:.3e} "
            f"(atol {SCAN_TOL:g}, rtol {SCAN_TOL:g}) ok")
        return err

    mains, errs = {}, {}
    for s_len in SCAN_LENGTHS:
        args = case(1, s_len, 4096, True)
        err = check(f"recurrentgemma-9b prefill B=1 S={s_len} Dr=4096 h0",
                    args)
        if s_len in SCAN_BUCKETS:
            mains[s_len], errs[s_len] = args, err
    for b in (1, 3):
        for dr in (128, 4000):
            for with_h0 in (True, False):
                check(f"sweep B={b} S=257 Dr={dr} "
                      f"{'h0' if with_h0 else 'no h0'}",
                      case(b, 257, dr, with_h0))

    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    times = {}
    for s_len in SCAN_BUCKETS:
        a, bb, h0 = mains[s_len]
        b, _, dr = a.shape
        ms = time_ms(torch, lambda: rs.rglru_scan(a, bb, h0), 50, flush)
        plain_ms = time_ms(torch, lambda: ref.rglru_scan_ref(a, bb, h0), 3,
                           flush)
        # not the recurrence: a + b moves the same bytes (a and b read,
        # one tensor written), so it shows what the memory gives this
        # traffic
        o = torch.empty_like(a)
        add_ms = time_ms(torch, lambda: torch.add(a, bb, out=o), 50, flush)
        # a and b read once, every h_t written once: 12 bytes a step and
        # channel, 2 flops
        t_bytes = 12 * b * s_len * dr / HBM_BYTES_PER_S
        t_ops = 2 * b * s_len * dr / PEAK_FLOPS["float32"]
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[scan] times at recurrentgemma-9b prefill B={b} S={s_len} "
            f"Dr={dr} float32, cold L2: kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms=none (no single PyTorch "
            f"call computes the recurrence) bound_ms={bound_ms:.4f} "
            f"({bound_by}); kernel at {bound_ms / ms:.1%} of the bound; "
            f"a + b over the same bytes {add_ms:.4f}; previous design "
            f"{PREV_MS[f'scan {s_len}']:.4f} ms on {PREV_CARD}")
        times[s_len] = {"max_abs_err": errs[s_len], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None,
                        "same_bytes_add_ms": add_ms}
    # host cost of a call at the smallest bucket: checks, allocation, the
    # tensor maps' encoding and the launch, with the card kept busy
    a, bb, h0 = mains[SCAN_BUCKETS[0]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        rs.rglru_scan(a, bb, h0)
    host_us = (time.perf_counter() - t0) / 100 * 1e6
    torch.cuda.synchronize()
    log(f"[scan] host time of a wrapper call at S={SCAN_BUCKETS[0]}: "
        f"{host_us:.2f} us (device {times[SCAN_BUCKETS[0]]['ms'] * 1e3:.2f} "
        f"us)")
    return {**times[SCAN_BUCKETS[-1]], "host_us_per_call": host_us,
            "buckets": {str(k): v for k, v in times.items()}}


def phase_parity(torch, np):
    """The port on the CPU (plain versions) against the port on the card
    (the kernels), float32, on identical weights: the chunked path of a
    yi-9b-shaped model (also with global pools swapped by the offloader,
    N_B = 4, equal swap counts on both devices), the exact path of a
    (local, global) model and of an (rglru, rglru, local) model."""
    import dataclasses

    from repro_torch.config import get_arch
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import Runtime
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import LLM, EngineConfig
    from repro_torch.serving.request import SamplingParams

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
    yi2 = dataclasses.replace(get_arch("yi-9b"), name="yi-9b-2layer",
                              num_layers=2, d_model=512, d_ff=1024,
                              vocab_size=2048)
    local_pool = dict(mb_size=4, num_microbatches=2, pool=PoolConfig(
        page_size=16, n_local_pages=8 * 16 + 1, max_pages_per_seq=16))
    models = {
        # chunked prefill, the paged kernel
        "yi-9b-2layer": (yi2, (20, 200), True),
        # the same with 31 local pages and two global pools of 64 over 4 x 4
        # slots: microbatches 0 and 2 share G0 and swap it every tick
        "yi-9b-2layer-offload": (yi2, (20, 200), True),
        # exact prefill through the flash kernel (both layers; head_dim 64
        # so the kernels take it), a 32-slot ring, the paged kernel
        "gemma3-local-global": (dataclasses.replace(
            get_arch("gemma3-12b"), name="gemma3-local-global",
            num_layers=4, block_pattern=("local", "global"), d_model=512,
            num_heads=8, num_kv_heads=4, head_dim=64, d_ff=1024,
            vocab_size=2048, window_size=32), (20, 101), False),
        # exact prefill through the scan kernel (3 rglru layers) and the
        # flash kernel at G = 16 (the local layer), recurrent states reset
        # as 10 requests pass through 8 slots, a 32-slot ring
        "recurrentgemma-rglru-local": (dataclasses.replace(
            get_arch("recurrentgemma-9b"), name="recurrentgemma-rglru-local",
            num_layers=4, d_model=512, d_rnn=512, num_heads=16,
            num_kv_heads=1, head_dim=64, d_ff=1024, vocab_size=2048,
            window_size=32), (20, 101), False),
    }
    sp = SamplingParams(temperature=0.0, max_new_tokens=16)
    for label, (cfg, (lo, hi), chunked) in models.items():
        cpu_params = model_lib.init_params(cfg, SEED, rt, "cpu")
        rng = np.random.RandomState(SEED + 1)
        lens = rng.randint(lo, hi, 10)
        if not chunked:   # past the window and not a multiple of 8
            lens[:3] = (33, 61, 100)
        prompts = [list(rng.randint(1, cfg.vocab_size, n)) for n in lens]
        streams, swaps = {}, {}
        for dev in ("cpu", "cuda"):
            params = {"embed": {k: v.to(dev) for k, v in
                                cpu_params["embed"].items()},
                      "final_norm": cpu_params["final_norm"].to(dev),
                      "layers": [{k: v.to(dev) for k, v in w.items()}
                                 for w in cpu_params["layers"]]}
            layout = local_pool if "offload" not in label else dict(
                mb_size=4, num_microbatches=4, pool=PoolConfig(
                    page_size=16, n_local_pages=32, n_global_pages=64,
                    max_pages_per_seq=16))
            llm = LLM(cfg, config=EngineConfig(**layout), params=params,
                      rt=rt, device=dev)
            if llm.engine.chunked_prefill != chunked:
                raise AssertionError(f"parity {label}: chunked prefill "
                                     f"{llm.engine.chunked_prefill}, want "
                                     f"{chunked}")
            outs = llm.generate(prompts, sp)
            if not all(o.finished and len(o.token_ids) == 16 for o in outs):
                raise AssertionError(f"parity {label} on {dev}: unfinished "
                                     "requests")
            streams[dev] = [o.token_ids for o in outs]
            swaps[dev] = llm.engine.backend.swap_count
            log(f"[parity] {label} on {dev}: {len(outs)} greedy streams, "
                f"prompts {int(lens.min())}-{int(lens.max())} tokens, "
                f"{'chunked' if chunked else 'exact'} prefill, "
                f"{llm.engine.backend.decode_ticks} decode ticks, "
                f"{swaps[dev]} swaps")
        if swaps["cpu"] != swaps["cuda"] or \
                ("offload" in label) != (swaps["cpu"] > 0):
            raise AssertionError(f"parity {label}: swaps {swaps}")
        if streams["cpu"] != streams["cuda"]:
            bad = [i for i, (a, b) in enumerate(zip(streams["cpu"],
                                                    streams["cuda"]))
                   if a != b]
            raise AssertionError(f"parity {label}: greedy streams differ "
                                 f"CPU vs card: {bad}")
        log(f"[parity] {label}: greedy streams identical, plain path (CPU) "
            "vs kernel path (card)")


def phase_serve(torch, np, card: str, params):
    from repro_torch.config import get_arch
    from repro_torch.models.common import Runtime
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import LLM, EngineConfig
    from repro_torch.serving.request import SamplingParams

    cfg = get_arch("yi-9b")
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    mb_size, n_mb, max_pages = SERVE_MB, SERVE_N_MB, SERVE_MAX_PAGES
    n_req, max_new = SERVE_REQUESTS, SERVE_NEW
    torch.cuda.reset_peak_memory_stats()
    econf = EngineConfig(
        mb_size=mb_size, num_microbatches=n_mb,
        pool=PoolConfig(page_size=SERVE_PAGE, n_local_pages=SERVE_POOL_PAGES,
                        max_pages_per_seq=max_pages),
        seed=SEED, max_prefill_tokens_per_tick=256)
    llm = LLM(cfg, config=econf, params=params, rt=rt, reduced=False,
              device="cuda")
    rng = np.random.RandomState(SEED)
    lens = rng.randint(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1, n_req)
    prompts = [list(rng.randint(1, cfg.vocab_size, n)) for n in lens]
    sps = [SamplingParams(temperature=0.0, max_new_tokens=max_new,
                          logprobs=True) if i % 2 == 0 else
           SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                          max_new_tokens=max_new, logprobs=True)
           for i in range(n_req)]
    reset_counts()
    t1 = time.perf_counter()
    outs = llm.generate(prompts, sps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = read_counts()
    launches = counts["paged_attention"]
    flash_launches = counts["flash_attention"]
    rep = llm.stats()
    ticks = rep["decode_ticks"]
    bad = [o.request_id for o in outs
           if not o.finished or len(o.token_ids) != max_new
           or not all(math.isfinite(x) for x in o.logprobs)
           or not all(0 <= t < cfg.vocab_size for t in o.token_ids)]
    if bad:
        raise AssertionError(f"serve: requests {bad} unfinished, short, or "
                             "with non-finite log-probs")
    if ticks == 0 or launches != ticks * YI_LAYERS:
        raise AssertionError(f"serve: {launches} kernel launches for {ticks} "
                             f"decode ticks x {YI_LAYERS} layers")
    if flash_launches or counts["rglru_scan"]:   # fully paged, chunked
        raise AssertionError(f"serve: {flash_launches} flash and "
                             f"{counts['rglru_scan']} scan launches on the "
                             "chunked path of an attention-only arch")
    ttft = sorted(o.ttft_s for o in outs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gen = sum(len(o.token_ids) for o in outs)
    log(f"[serve] {len(outs)}/{n_req} requests finished, {max_new} tokens "
        f"each; prompts {int(lens.min())}-{int(lens.max())} tokens "
        f"({int(lens.sum())} total); batch {mb_size}x{n_mb}, page "
        f"{SERVE_PAGE}, "
        f"max_pages_per_seq {max_pages}, prefill chunk "
        f"{llm.engine.prefill_chunk} x {llm.engine.prefill_rows} rows")
    log(f"[serve] on {card}: decode_tok_per_s={rep['decode_tok_per_s']:.1f} "
        f"prefill_tok_per_s={rep['prefill_tok_per_s']:.1f} "
        f"(engine phase clocks; decode {rep['decode_time_s']:.3f}s, "
        f"prefill {rep['prefill_time_s']:.3f}s); wall {wall:.3f}s for "
        f"{gen} generated + {rep['prefill_tokens']} prompt tokens")
    log(f"[serve] ttft_s p50={ttft[len(ttft) // 2]:.3f} max={ttft[-1]:.3f} "
        f"mean={sum(ttft) / len(ttft):.3f} (n={len(ttft)}); "
        f"peak_mem_gib={peak:.2f}; engine steps {rep['steps']}, decode "
        f"ticks {ticks}, paged-kernel launches {launches} "
        f"(= {ticks} x {YI_LAYERS})")
    return counts


def phase_serve_gemma(torch, np, card: str):
    import gc

    from repro_torch.config import get_arch
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import Runtime
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import LLM, EngineConfig
    from repro_torch.serving.request import SamplingParams

    gc.collect()                        # the yi-9b phase's weights and pools
    torch.cuda.empty_cache()
    cfg = get_arch("gemma3-12b")
    kinds = cfg.layer_kinds()
    n_global = sum(k == "global" for k in kinds)
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, SEED, rt, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in
                   [*params["embed"].values(), params["final_norm"]]
                   + [w for layer in params["layers"] for w in layer.values()])
    log(f"[gemma3] gemma3-12b full width and depth: {cfg.num_layers} layers "
        f"({kinds.count('local')} local, window {cfg.window_size}; "
        f"{n_global} global), {n_params / 1e9:.3f}B params bf16 from seed "
        f"{SEED} in {time.perf_counter() - t0:.1f}s")
    econf = EngineConfig(
        mb_size=GEMMA_MB, num_microbatches=1,
        pool=PoolConfig(page_size=GEMMA_PAGE, n_local_pages=GEMMA_POOL_PAGES,
                        max_pages_per_seq=GEMMA_MAX_PAGES),
        seed=SEED, prefill_mode="auto")
    llm = LLM(cfg, config=econf, params=params, rt=rt, reduced=False,
              device="cuda")
    if llm.engine.chunked_prefill:
        raise AssertionError("gemma3: prefill_mode='auto' picked chunked "
                             "prefill for a sliding-window arch")
    rng = np.random.RandomState(SEED)
    lens = rng.randint(GEMMA_PROMPTS[0], GEMMA_PROMPTS[1] + 1, GEMMA_REQUESTS)
    prompts = [list(rng.randint(1, cfg.vocab_size, n)) for n in lens]
    sps = [SamplingParams(temperature=0.0, max_new_tokens=GEMMA_NEW,
                          logprobs=True) if i % 2 == 0 else
           SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                          max_new_tokens=GEMMA_NEW, logprobs=True)
           for i in range(GEMMA_REQUESTS)]
    reset_counts()
    t1 = time.perf_counter()
    outs = llm.generate(prompts, sps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = read_counts()
    paged = counts["paged_attention"]
    flash = counts["flash_attention"]
    rep = llm.stats()
    ticks = rep["decode_ticks"]
    bad = [o.request_id for o in outs
           if not o.finished or len(o.token_ids) != GEMMA_NEW
           or not all(math.isfinite(x) for x in o.logprobs)
           or not all(0 <= t < cfg.vocab_size for t in o.token_ids)]
    if bad:
        raise AssertionError(f"gemma3: requests {bad} unfinished, short, or "
                             "with non-finite log-probs")
    if flash != GEMMA_REQUESTS * cfg.num_layers:
        raise AssertionError(f"gemma3: {flash} flash launches, want "
                             f"{GEMMA_REQUESTS} requests x {cfg.num_layers} "
                             "layers")
    if ticks == 0 or paged != ticks * n_global:
        raise AssertionError(f"gemma3: {paged} paged launches for {ticks} "
                             f"decode ticks x {n_global} global layers")
    if counts["rglru_scan"]:
        raise AssertionError(f"gemma3: {counts['rglru_scan']} scan launches "
                             "on an arch without recurrent layers")
    ttft = sorted(o.ttft_s for o in outs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gen = sum(len(o.token_ids) for o in outs)
    log(f"[gemma3] {len(outs)}/{GEMMA_REQUESTS} requests finished, "
        f"{GEMMA_NEW} tokens each; prompts {int(lens.min())}-"
        f"{int(lens.max())} tokens ({int(lens.sum())} total, "
        f"{int((lens > cfg.window_size).sum())} past the window); batch "
        f"{GEMMA_MB}x1, page {GEMMA_PAGE}, max_pages_per_seq "
        f"{GEMMA_MAX_PAGES}; exact-length prefill")
    log(f"[gemma3] on {card}: decode_tok_per_s={rep['decode_tok_per_s']:.1f} "
        f"prefill_tok_per_s={rep['prefill_tok_per_s']:.1f} "
        f"(engine phase clocks; decode {rep['decode_time_s']:.3f}s, "
        f"prefill {rep['prefill_time_s']:.3f}s); wall {wall:.3f}s for "
        f"{gen} generated + {rep['prefill_tokens']} prompt tokens")
    log(f"[gemma3] ttft_s p50={ttft[len(ttft) // 2]:.3f} max={ttft[-1]:.3f} "
        f"mean={sum(ttft) / len(ttft):.3f} (n={len(ttft)}); "
        f"peak_mem_gib={peak:.2f}; engine steps {rep['steps']}, decode "
        f"ticks {ticks}, flash launches {flash} (= {GEMMA_REQUESTS} x "
        f"{cfg.num_layers}), paged launches {paged} (= {ticks} x "
        f"{n_global})")
    return counts


def ring_loss(lengths, bucket, window: int):
    """In-window prompt tokens that the reference's padded-ring behaviour
    (ROADMAP Queue 3) keeps out of a ring of ``window`` slots: a prompt of
    n tokens is padded to P = ``bucket(n)``, and when P > window the ring
    receives only the last ``window`` positions of the *padded* sequence,
    of which positions P - window .. n - 1 are real; the next token's
    window wants the last min(n, window).  Returns (total, max, requests
    that lost any)."""
    lost = []
    for n in lengths:
        held = n - max(bucket(n) - window, 0)
        lost.append(min(n, window) - max(held, 0))
    return sum(lost), max(lost), sum(1 for x in lost if x)


def phase_serve_recurrentgemma(torch, np, card: str):
    import gc

    from repro_torch.config import get_arch
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import Runtime
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import LLM, EngineConfig
    from repro_torch.serving.request import SamplingParams

    gc.collect()                        # the gemma3 phase's weights and rings
    torch.cuda.empty_cache()
    cfg = get_arch("recurrentgemma-9b")
    kinds = cfg.layer_kinds()
    n_rglru, n_local = kinds.count("rglru"), kinds.count("local")
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, SEED, rt, "cuda")
    torch.cuda.synchronize()
    leaves = [*params["embed"].values(), params["final_norm"]] + \
        [w for layer in params["layers"] for w in layer.values()]
    n_params = sum(t.numel() for t in leaves)
    n_f32 = sum(t.numel() for t in leaves if t.dtype == torch.float32)
    log(f"[recurrentgemma] recurrentgemma-9b full width and depth: "
        f"{cfg.num_layers} layers ({n_rglru} rglru, d_rnn {cfg.d_rnn}; "
        f"{n_local} local, window {cfg.window_size}, {cfg.num_heads} heads "
        f"over {cfg.num_kv_heads}), {n_params / 1e9:.3f}B params bf16 "
        f"({n_f32} float32 gate biases and Lambda) from seed {SEED} in "
        f"{time.perf_counter() - t0:.1f}s")
    econf = EngineConfig(
        mb_size=RG_MB, num_microbatches=1,
        pool=PoolConfig(page_size=RG_PAGE, n_local_pages=RG_POOL_PAGES,
                        max_pages_per_seq=RG_MAX_PAGES),
        seed=SEED, prefill_mode="auto")
    llm = LLM(cfg, config=econf, params=params, rt=rt, reduced=False,
              device="cuda")
    engine = llm.engine
    if engine.chunked_prefill:
        raise AssertionError("recurrentgemma: prefill_mode='auto' picked "
                             "chunked prefill for a recurrent arch")
    rng = np.random.RandomState(SEED)
    lens = rng.randint(RG_PROMPTS[0], RG_PROMPTS[1] + 1, RG_REQUESTS)
    prompts = [list(rng.randint(1, cfg.vocab_size, n)) for n in lens]
    sps = [SamplingParams(temperature=0.0, max_new_tokens=RG_NEW,
                          logprobs=True) if i % 2 == 0 else
           SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                          max_new_tokens=RG_NEW, logprobs=True)
           for i in range(RG_REQUESTS)]
    reset_counts()
    t1 = time.perf_counter()
    outs = llm.generate(prompts, sps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = read_counts()
    rep = llm.stats()
    ticks = rep["decode_ticks"]
    bad = [o.request_id for o in outs
           if not o.finished or len(o.token_ids) != RG_NEW
           or not all(math.isfinite(x) for x in o.logprobs)
           or not all(0 <= t < cfg.vocab_size for t in o.token_ids)]
    if bad:
        raise AssertionError(f"recurrentgemma: requests {bad} unfinished, "
                             "short, or with non-finite log-probs")
    want = {"rglru_scan": RG_REQUESTS * n_rglru,
            "flash_attention": RG_REQUESTS * n_local, "paged_attention": 0}
    if counts != want:
        raise AssertionError(f"recurrentgemma: launches {counts}, want "
                             f"{want} ({RG_REQUESTS} requests x {n_rglru} "
                             f"rglru / {n_local} local layers, no paged "
                             "layer)")
    buckets = sorted({engine._prefill_len(int(n)) for n in lens})
    lost, lost_max, n_lossy = ring_loss([int(n) for n in lens],
                                        engine._prefill_len, cfg.window_size)
    ttft = sorted(o.ttft_s for o in outs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gen = sum(len(o.token_ids) for o in outs)
    log(f"[recurrentgemma] {len(outs)}/{RG_REQUESTS} requests finished, "
        f"{RG_NEW} tokens each; prompts {int(lens.min())}-{int(lens.max())} "
        f"tokens ({int(lens.sum())} total, "
        f"{int((lens > cfg.window_size).sum())} past the window), bucketed "
        f"to {buckets}; batch {RG_MB}x1, page {RG_PAGE}, max_pages_per_seq "
        f"{RG_MAX_PAGES}; exact-length prefill")
    log(f"[recurrentgemma] on {card}: "
        f"decode_tok_per_s={rep['decode_tok_per_s']:.1f} "
        f"prefill_tok_per_s={rep['prefill_tok_per_s']:.1f} "
        f"(engine phase clocks, prompt tokens without padding; decode "
        f"{rep['decode_time_s']:.3f}s, prefill {rep['prefill_time_s']:.3f}s)"
        f"; wall {wall:.3f}s for {gen} generated + {rep['prefill_tokens']} "
        f"prompt tokens")
    log(f"[recurrentgemma] ttft_s p50={ttft[len(ttft) // 2]:.3f} "
        f"max={ttft[-1]:.3f} mean={sum(ttft) / len(ttft):.3f} "
        f"(n={len(ttft)}); peak_mem_gib={peak:.2f}; engine steps "
        f"{rep['steps']}, decode ticks {ticks}, scan launches "
        f"{counts['rglru_scan']} (= {RG_REQUESTS} x {n_rglru}), flash "
        f"launches {counts['flash_attention']} (= {RG_REQUESTS} x "
        f"{n_local}), paged launches {counts['paged_attention']}")
    log(f"[recurrentgemma] padded-ring loss (reference behaviour, ROADMAP "
        f"Queue 3): {lost} in-window prompt tokens never reached the rings "
        f"over {n_lossy} of {RG_REQUESTS} requests (at most {lost_max} for "
        f"one request; window {cfg.window_size})")
    return counts


def phase_group_sizes(torch, np):
    """Both attention kernels at group sizes they are not built for: each
    kv head's group padded with zero query rows (G = 3 -> 4, 6 -> 8) or,
    for the paged kernel, cut into launches of 8 (G = 16), against the
    plain version; then each timed beside the sizes the kernels are built
    for (4, 8), at yi-9b's decode shape (paged, cold L2) and a 2,048-token
    causal prefill (flash)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import groups
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 4)
    torch.manual_seed(SEED + 4)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    def check(label, kernel, plain, args, kw, g, sizes):
        name = str(args[0].dtype).split(".")[-1]
        atol, rtol = TOL[name]
        n0 = kernel.launches
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        n_launch = kernel.launches - n0
        want = plain(*args, **kw)
        if n_launch != len(groups.group_plan(g, sizes)):
            raise AssertionError(f"{label}: {n_launch} launches")
        if got.shape != want.shape or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{label}: shape {tuple(got.shape)} or "
                                 "non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol, msg=lambda m: f"{label}: {m}")
        log(f"[groups] {label} {name}: {n_launch} launch(es), max |kernel - "
            f"plain| = {err:.3e} (atol {atol:g}, rtol {rtol:g}) ok")
        return err

    out = {"paged": {}, "flash": {}}
    B, HK, DH, PAGE, MAXP = 16, 4, 128, 16, 128
    lens = rng.randint(1, MAXP * PAGE + 1, B)
    lens[1] = MAXP * PAGE
    for g in PAGED_GROUPS:
        for dtype in (torch.bfloat16, torch.float32):
            args = paged_case(torch, np, rng, b=B, h=HK * g, hk=HK, dh=DH,
                              page=PAGE, max_pages=MAXP, lens=lens,
                              dtype=dtype, device=dev)
            for win in (0, 500):
                err = check(f"paged G={g} B={B} Hk={HK} Dh={DH} window={win}",
                            pa.paged_decode_attention,
                            ref.paged_decode_attention_ref, args,
                            {"window": win}, g, pa.GROUP_SIZES)
            if dtype == torch.bfloat16:
                call = lambda: pa.paged_decode_attention(*args)  # noqa: E731
                ms = time_ms(torch, call, 50, flush, spin=GROUP_SPIN_CYCLES)
                wall_ms = time_ms(torch, call, 50, flush)
                b_ms, b_by, _ = bound(args[4].tolist(), 0, HK * g, HK, DH, 2,
                                      "bfloat16", B, MAXP)
                out["paged"][g] = {"ms": ms, "with_host_gaps_ms": wall_ms,
                                   "plain_ms": time_ms(
                                       torch, lambda: ref.
                                       paged_decode_attention_ref(*args),
                                       20, flush),
                                   "library_ms": time_ms(
                                       torch, paged_sdpa(torch, *args), 50,
                                       flush),
                                   "bound_ms": b_ms,
                                   "bound_by": b_by, "max_abs_err": err,
                                   "launches_a_call": len(groups.group_plan(
                                       g, pa.GROUP_SIZES))}
    for s_len in (100, 2048):
        for g in FLASH_GROUPS:
            for dtype in (torch.bfloat16, torch.float32):
                q = torch.randn((1, s_len, HK * g, DH), device=dev).to(dtype)
                k = torch.randn((1, s_len, HK, DH), device=dev).to(dtype)
                v = torch.randn((1, s_len, HK, DH), device=dev).to(dtype)
                for causal, win in ((True, 0), (True, 1024), (False, 0)):
                    err = check(f"flash G={g} S={s_len} Hk={HK} Dh={DH} "
                                f"causal={causal} window={win}",
                                fa.flash_attention, ref.flash_attention_ref,
                                (q, k, v), {"causal": causal, "window": win},
                                g, fa.GROUP_SIZES)
                if dtype == torch.bfloat16 and s_len == 2048:
                    call = lambda: fa.flash_attention(  # noqa: E731
                        q, k, v, causal=True)
                    ms = time_ms(torch, call, 20, spin=GROUP_SPIN_CYCLES)
                    wall_ms = time_ms(torch, call, 20)
                    b_ms, b_by, _ = flash_bound(s_len, s_len, True, 0, HK * g,
                                                HK, DH, 2, "bfloat16")
                    qt, kt, vt = (x.transpose(1, 2).contiguous()
                                  for x in (q, k, v))
                    sdpa = torch.nn.functional.scaled_dot_product_attention
                    out["flash"][g] = {
                        "ms": ms, "with_host_gaps_ms": wall_ms,
                        "plain_ms": time_ms(torch, lambda: ref.
                                            flash_attention_ref(
                                                q, k, v, causal=True), 5),
                        "library_ms": time_ms(torch, lambda: sdpa(
                            qt, kt, vt, is_causal=True, enable_gqa=True), 20),
                        "bound_ms": b_ms, "bound_by": b_by,
                        "max_abs_err": err, "launches_a_call": 1}
    for kind, shape in (("paged", f"B={B} Hk={HK} Dh={DH} page={PAGE} "
                                  f"tokens={int(lens.sum())}, cold L2"),
                        ("flash", f"B=1 S=2048 Hk={HK} Dh={DH} causal")):
        log(f"[groups] {kind} times at {shape}, bf16, device only (the "
            f"host ahead): " + "; ".join(
                f"G={g} {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, "
                f"plain {t['plain_ms']:.4f}, sdpa {t['library_ms']:.4f}, "
                f"{t['launches_a_call']} launch(es); "
                f"{t['with_host_gaps_ms']:.4f} ms with the host's gaps)"
                for g, t in out[kind].items()))
    for kind, pairs in (("paged", ((3, 4), (6, 8), (16, 8))),
                        ("flash", ((3, 4), (6, 8)))):
        t = out[kind]
        log(f"[groups] {kind} padding cost, device only: " + "; ".join(
            f"G={a} / G={b} = {t[a]['ms'] / t[b]['ms']:.3f}" +
            (" (two launches of 8 against one)" if a == 16 else
             f" (the work of G={b} plus the regroup copies)")
            for a, b in pairs))
    return {kind: {str(g): t for g, t in v.items()} for kind, v in out.items()}


def phase_swap_order(torch, np, card: str):
    """The offloader's stream ordering at yi-9b's full-width pools, exact.

    Each microbatch's global content is its own random data, kept as a
    reference copy on the card; ``ensure_resident`` visits microbatches
    0-3 round robin, ``SWAP_ROUNDS`` times.  After each swap the compute
    stream reads the resident slice (an exact comparison with the
    reference, and one paged-kernel launch over a table of the slice's
    pages against the same launch over the reference), spins, and writes
    a fresh signature into the slice and the reference.  Nothing is
    synchronised until the end, so a compute read before the swap-in
    lands, a snapshot taken before compute's writes, or a swap-in that
    overwrites the slice before its swap-out would all show as a
    mismatch."""
    from repro_torch.config import get_arch
    from repro_torch.core.offload import DoubleBufferOffloader
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.common import Runtime
    from repro_torch.serving import kv_cache as kvc

    cfg = get_arch("yi-9b")
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    dev = torch.device("cuda")
    pool = kvc.PoolConfig(page_size=SWAP_PAGE, n_local_pages=SWAP_LOCAL,
                          n_global_pages=SWAP_GLOBAL,
                          max_pages_per_seq=SWAP_GLOBAL)
    caches = kvc.build_paged_caches(cfg, 16, pool, rt, dev)
    layers = [lay for lay in caches["layers"] if "k_pages" in lay]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    shape = (SWAP_GLOBAL, SWAP_PAGE, cfg.num_kv_heads, cfg.head_dim)
    refs = {mb: [torch.zeros(shape, dtype=torch.bfloat16, device=dev)
                 for _ in range(2 * len(layers))] for mb in range(SWAP_MBS)}
    off = DoubleBufferOffloader(pool, SWAP_MBS)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    rows = 4                                  # 4 rows x 32 pages = the slice
    q = torch.randn((rows, cfg.num_heads, cfg.head_dim), generator=gen,
                    device=dev).to(torch.bfloat16)
    seq_lens = torch.tensor([512, 300, 17, 511], dtype=torch.int32,
                            device=dev)
    own = torch.arange(SWAP_GLOBAL, dtype=torch.int32, device=dev).view(
        rows, -1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = 0
    for _ in range(SWAP_ROUNDS):
        for mb in range(SWAP_MBS):
            off.ensure_resident(caches, mb)
            sl = kvc.global_slice(pool, mb % 2)
            views = [lay[n][sl] for lay in layers
                     for n in ("k_pages", "v_pages")]
            for view, r in zip(views, refs[mb]):
                bad += (view != r).sum()
            li = step % len(layers)
            got = pa.paged_decode_attention(
                q, layers[li]["k_pages"], layers[li]["v_pages"],
                own + sl.start, seq_lens)
            want = pa.paged_decode_attention(q, refs[mb][2 * li],
                                             refs[mb][2 * li + 1], own,
                                             seq_lens)
            bad += (got != want).sum()
            torch.cuda._sleep(SWAP_SPIN_CYCLES)
            for view, r in zip(views, refs[mb]):
                r.normal_(generator=gen)
                view.copy_(r)
            step += 1
    enqueue_s = time.perf_counter() - t0
    off.settle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_bad = int(bad.item())
    copy_ms, wait_ms = off.swap_timings()
    slice_bytes = pool_slice_bytes(caches, pool)
    moving = step - 2                 # the first visit of each parity moves
    want_bytes = moving * 2 * slice_bytes          # nothing; the rest out+in
    if n_bad or off.swap_count != step or off.bytes_swapped != want_bytes:
        raise AssertionError(
            f"swap order: {n_bad} mismatched elements, swap_count "
            f"{off.swap_count} (want {step}), bytes_swapped "
            f"{off.bytes_swapped} (want {want_bytes})")
    if len(copy_ms) != moving:
        raise AssertionError(f"swap order: {len(copy_ms)} timed swaps, "
                             f"want {moving}")
    log(f"[swap-order] yi-9b pools: {len(layers)} layers bf16, 2 global "
        f"pools of {SWAP_GLOBAL} pages ({slice_bytes / 2 ** 20:.1f} MiB a "
        f"slice), {SWAP_MBS} microbatches x {SWAP_ROUNDS} rounds: {step} "
        f"swaps, {off.bytes_swapped / 2 ** 30:.3f} GiB moved, pinned host "
        f"{off.host_bytes / 2 ** 30:.3f} GiB; every read and every paged "
        f"launch equal to the reference exactly (0 mismatches)")
    q25, q50, q75 = np.percentile(copy_ms, [25, 50, 75])
    log(f"[swap-order] on {card}: copy stream {np.mean(copy_ms):.3f} ms a "
        f"swap (median {q50:.3f}, quartiles {q25:.3f}-{q75:.3f}, min "
        f"{min(copy_ms):.3f}, max {max(copy_ms):.3f}; "
        f"{2 * slice_bytes / q50 / 1e6:.2f} GB/s out + in at the median), "
        f"compute-stream wait {np.mean(wait_ms):.3f} ms a swap; host enqueue "
        f"{enqueue_s:.3f} s, wall {wall:.3f} s")
    return {"swaps": step, "copy_ms": float(np.mean(copy_ms)),
            "copy_ms_median": float(q50), "wait_ms": float(np.mean(wait_ms))}


def pool_slice_bytes(caches, pool) -> int:
    """Bytes of one global pool's page rows across every paged layer's K
    and V pools: what one direction of a swap moves."""
    from repro_torch.serving.kv_cache import global_slice
    sl = global_slice(pool, 0)
    return sum(lay[n][sl].numel() * lay[n].element_size()
               for lay in caches["layers"] if "k_pages" in lay
               for n in ("k_pages", "v_pages"))


def _offload_line(tag, off, ticks, card):
    """The swap books and timings of an engine's offloader, printed."""
    copy_ms, wait_ms = off.swap_timings()
    if not copy_ms:
        raise AssertionError(f"{tag}: no swap was timed")
    copy, wait = sum(copy_ms) / len(copy_ms), sum(wait_ms) / len(wait_ms)
    hidden = 1.0 - sum(wait_ms) / sum(copy_ms)
    log(f"[{tag}] offload on {card}: {off.swap_count} swaps over {ticks} "
        f"decode ticks, {off.bytes_swapped / 2 ** 30:.3f} GiB moved, pinned "
        f"host {off.host_bytes / 2 ** 30:.3f} GiB; copy stream {copy:.3f} ms "
        f"a swap, compute-stream wait {wait:.3f} ms a swap, hidden share "
        f"1 - wait / copy = {hidden:.3f} ({len(copy_ms)} timed swaps)")
    return {"swaps": off.swap_count, "bytes_swapped": off.bytes_swapped,
            "host_bytes": off.host_bytes, "copy_ms": copy, "wait_ms": wait,
            "timed_swaps": len(copy_ms), "hidden_share": hidden}


def _count_refusals(engine):
    """Count the allocator's MemoryErrors (a request that waits for
    pages) by wrapping this engine's ``allocate``."""
    orig = engine.alloc.allocate
    refused = [0]

    def allocate(*a, **k):
        try:
            return orig(*a, **k)
        except MemoryError:
            refused[0] += 1
            raise
    engine.alloc.allocate = allocate
    return refused


def _serve_yi(torch, np, llm, tag, card):
    """Serve the yi-9b phase's 20 requests through ``llm``; check every
    request finishes at full length with finite log-probs; return the
    outputs, the report and the launch counts."""
    from repro_torch.serving.request import SamplingParams
    cfg = llm.cfg
    rng = np.random.RandomState(SEED)
    lens = rng.randint(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1,
                       SERVE_REQUESTS)
    prompts = [list(rng.randint(1, cfg.vocab_size, n)) for n in lens]
    sps = [SamplingParams(temperature=0.0, max_new_tokens=SERVE_NEW,
                          logprobs=True) if i % 2 == 0 else
           SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                          max_new_tokens=SERVE_NEW, logprobs=True)
           for i in range(SERVE_REQUESTS)]
    reset_counts()
    t1 = time.perf_counter()
    outs = llm.generate(prompts, sps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = read_counts()
    rep = llm.stats()
    bad = [o.request_id for o in outs
           if not o.finished or len(o.token_ids) != SERVE_NEW
           or not all(math.isfinite(x) for x in o.logprobs)
           or not all(0 <= t < cfg.vocab_size for t in o.token_ids)]
    if bad:
        raise AssertionError(f"{tag}: requests {bad} unfinished, short, or "
                             "with non-finite log-probs")
    ticks = rep["decode_ticks"]
    if ticks == 0 or counts["paged_attention"] != ticks * YI_LAYERS:
        raise AssertionError(f"{tag}: {counts['paged_attention']} paged "
                             f"launches for {ticks} ticks x {YI_LAYERS}")
    log(f"[{tag}] on {card}: decode_tok_per_s={rep['decode_tok_per_s']:.1f} "
        f"prefill_tok_per_s={rep['prefill_tok_per_s']:.1f} (decode "
        f"{rep['decode_time_s']:.3f}s over {ticks} ticks = "
        f"{rep['decode_time_s'] / ticks * 1e3:.2f} ms a tick, prefill "
        f"{rep['prefill_time_s']:.3f}s); wall {wall:.3f}s; steps "
        f"{rep['steps']}; paged launches {counts['paged_attention']}")
    return outs, rep, counts


def phase_serve_offload(torch, np, card: str, params):
    """Full-width yi-9b with global pools swapped through pinned host
    memory, beside an engine of local pages only, on the same weights and
    requests: every stream equal token for token."""
    import gc

    from repro_torch.config import get_arch
    from repro_torch.models.common import Runtime
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import LLM, EngineConfig

    cfg = get_arch("yi-9b")
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    runs = {}
    for tag, n_local, n_global in (("offload", OFF_LOCAL, OFF_GLOBAL),
                                   ("no-offload", OFF_BASE_LOCAL, 0)):
        gc.collect()
        torch.cuda.empty_cache()
        econf = EngineConfig(
            mb_size=OFF_MB, num_microbatches=OFF_N_MB,
            pool=PoolConfig(page_size=SERVE_PAGE, n_local_pages=n_local,
                            n_global_pages=n_global,
                            max_pages_per_seq=SERVE_MAX_PAGES),
            seed=SEED, max_prefill_tokens_per_tick=256)
        llm = LLM(cfg, config=econf, params=params, rt=rt, reduced=False,
                  device="cuda")
        refused = _count_refusals(llm.engine)
        outs, rep, counts = _serve_yi(torch, np, llm, f"serve-{tag}", card)
        holders = sum(s.global_parity is not None
                      for s in llm.engine.finished)
        if refused[0]:
            raise AssertionError(f"serve-{tag}: {refused[0]} allocations "
                                 "refused; the pools are sized so none is")
        log(f"[serve-{tag}] pools: {n_local} local pages, 2 x {n_global} "
            f"global; {holders} of {SERVE_REQUESTS} requests hold global "
            f"pages; batch {OFF_MB}x{OFF_N_MB}")
        off = llm.engine.backend.offloader
        info = {"outs": outs, "rep": rep, "counts": counts,
                "holders": holders}
        if off is not None:
            touched = sum(m is not None for m in off.resident.values())
            want = (off.swap_count - touched) * 2 * pool_slice_bytes(
                llm.engine.backend.caches, llm.engine.pool)
            if off.bytes_swapped != want or off.swap_count < 2:
                raise AssertionError(
                    f"serve-offload: bytes_swapped {off.bytes_swapped}, "
                    f"want {want} for {off.swap_count} swaps")
            if 4 * holders < SERVE_REQUESTS:
                raise AssertionError(f"serve-offload: only {holders} "
                                     "requests hold global pages")
            info["offload"] = _offload_line("serve-offload", off,
                                            rep["decode_ticks"], card)
        runs[tag] = info
        del llm
    a, b = runs["offload"]["outs"], runs["no-offload"]["outs"]
    diff = [o.request_id for o, p in zip(a, b) if o.token_ids != p.token_ids]
    if diff:
        raise AssertionError(f"serve-offload: streams of requests {diff} "
                             "differ from the no-offload engine's")
    lp = max(abs(x - y) for o, p in zip(a, b)
             for x, y in zip(o.logprobs, p.logprobs))
    log(f"[serve-offload] all {len(a)} streams (greedy and sampled) equal "
        f"the no-offload engine's token for token; max |log-prob "
        f"difference| {lp:.3e}")
    # end to end: how much longer an offloaded tick is, against the copy
    # stream's time a tick
    tick = {tag: r["rep"]["decode_time_s"] / r["rep"]["decode_ticks"] * 1e3
            for tag, r in runs.items()}
    info = runs["offload"]["offload"]
    copy_a_tick = info["copy_ms"] * info["timed_swaps"] / \
        runs["offload"]["rep"]["decode_ticks"]
    extra = tick["offload"] - tick["no-offload"]
    info.update(tick_ms=tick, copy_ms_a_tick=copy_a_tick,
                shown_share=extra / copy_a_tick,
                decode_tok_per_s={t: r["rep"]["decode_tok_per_s"]
                                  for t, r in runs.items()},
                prefill_tok_per_s={t: r["rep"]["prefill_tok_per_s"]
                                   for t, r in runs.items()})
    log(f"[serve-offload] end to end on {card}: a decode tick takes "
        f"{tick['offload']:.2f} ms offloaded, {tick['no-offload']:.2f} ms "
        f"without ({extra:+.2f} ms); the copy stream spends "
        f"{copy_a_tick:.2f} ms a tick, of which {extra / copy_a_tick:.1%} "
        f"shows in the tick (the rest overlaps the host issuing the step)")
    return {tag: r["counts"] for tag, r in runs.items()}, info


def allocator_capacity(pool, n_b: int):
    """Pages each microbatch gets when all ``n_b`` of them fill a fresh
    allocator a page at a time, round robin, microbatch ``m`` drawing its
    overflow from parity ``m % 2``, until every one is refused."""
    from repro_torch.serving.kv_cache import PageAllocator
    al = PageAllocator(pool)
    got = [0] * n_b
    live = set(range(n_b))
    while live:
        for mb in sorted(live):
            try:
                al.allocate(mb, 1, global_pool=mb % 2)
                got[mb] += 1
            except MemoryError:
                live.discard(mb)
    return got


def phase_plan(torch, np, card: str, params):
    """The §4.3 planner at full width: the card's pinned copy rate and a
    measured stage time feed ``EngineConfig.plan``; the planned engine
    serves the yi-9b requests."""
    import gc

    from repro_torch.config import get_arch
    from repro_torch.core.offload import OffloadPlan
    from repro_torch.core.scheduler import plan_schedule
    from repro_torch.launch.serve import measure_stage_time, pinned_copy_rate
    from repro_torch.models.common import Runtime
    from repro_torch.serving.kv_cache import PoolConfig, kv_bytes_per_page
    from repro_torch.serving.llm import LLM, EngineConfig

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch("yi-9b")
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    dev = torch.device("cuda")
    h2d, d2h = pinned_copy_rate(dev, PLAN_COPY_BYTES)
    bandwidth = min(h2d, d2h)
    t_s = measure_stage_time(cfg, params, rt, PLAN_STAGES, dev)
    page_bytes = kv_bytes_per_page(
        cfg, PoolConfig(page_size=SERVE_PAGE),
        dtype_bytes=torch.empty((), dtype=rt.compute_dtype).element_size())
    kw = dict(n_stages=PLAN_STAGES, stage_time=t_s, latency=PLAN_LATENCY,
              bandwidth=bandwidth, page_size=SERVE_PAGE,
              max_pages_per_seq=SERVE_MAX_PAGES, mb_size_cap=4,
              max_microbatches=16)
    m_kv, note = PLAN_KV_BYTES, ""
    while True:
        choice = plan_schedule(
            n_stages=PLAN_STAGES, stage_time=t_s, latency=PLAN_LATENCY,
            m_kv_bytes=m_kv, kv_bytes_per_seq=page_bytes * SERVE_MAX_PAGES,
            offload_bandwidth=bandwidth, max_microbatches=16)
        plan = OffloadPlan.derive(
            m_kv_bytes=m_kv, page_bytes=page_bytes, page_size=SERVE_PAGE,
            max_pages_per_seq=SERVE_MAX_PAGES, bandwidth=bandwidth,
            stage_time=t_s, n_microbatches=choice.n_microbatches)
        host = choice.n_microbatches * plan.m_g_bytes
        if host <= PLAN_MAX_HOST_BYTES:
            break
        note = (f"; m_kv_bytes lowered from {PLAN_KV_BYTES / 2 ** 30:.2f} "
                f"GiB so that the pinned host store fits "
                f"{PLAN_MAX_HOST_BYTES / 2 ** 30:.0f} GiB")
        m_kv *= 0.75
    log(f"[plan] on {card}: pinned copy rate H2D {h2d / 1e9:.2f} GB/s, D2H "
        f"{d2h / 1e9:.2f} GB/s ({PLAN_COPY_BYTES >> 20} MiB a copy); "
        f"measured stage_time {t_s * 1e3:.2f} ms (one single-sequence "
        f"decode step / {PLAN_STAGES} stages); latency "
        f"{PLAN_LATENCY * 1e3:.0f} ms; m_kv_bytes {m_kv / 2 ** 30:.3f} GiB"
        f"{note}; implied pinned host store {host / 2 ** 30:.3f} GiB")
    econf = EngineConfig.plan(m_kv_bytes=m_kv, seed=SEED,
                              max_prefill_tokens_per_tick=256, **kw)
    llm = LLM(cfg, config=econf, params=params, rt=rt, reduced=False,
              device="cuda")
    eng = llm.engine
    if eng.schedule_choice != choice or eng.pool != plan.pool:
        raise AssertionError(f"plan: engine {eng.schedule_choice} / "
                             f"{eng.pool}, want {choice} / {plan.pool}")
    n_b = eng.num_microbatches
    formula1 = plan.capacity_with_offload()
    actual = allocator_capacity(eng.pool, n_b)
    log(f"[plan] {eng.schedule_choice}; mb_size {eng.mb_size} (cap 4) x N_B "
        f"{n_b}; pool {eng.pool.n_local_pages} local + 2 x "
        f"{eng.pool.n_global_pages} global pages of "
        f"{page_bytes / 2 ** 20:.2f} MiB; prefill chunk "
        f"{eng.prefill_chunk} x {eng.prefill_rows} rows")
    log(f"[plan] per-microbatch KV capacity: Formula 1 "
        f"{formula1 / 2 ** 30:.3f} GiB = {formula1 / page_bytes:.1f} pages; "
        f"the allocator gives {min(actual)}-{max(actual)} pages a "
        f"microbatch when all {n_b} fill (one free list a parity, shared "
        f"by {n_b // 2}-{-(-n_b // 2)} microbatches: ROADMAP Queue 3), "
        f"{min(actual) * page_bytes / formula1:.1%} of Formula 1")
    refused = _count_refusals(eng)
    outs, rep, counts = _serve_yi(torch, np, llm, "plan", card)
    info = _offload_line("plan", eng.backend.offloader, rep["decode_ticks"],
                         card) if eng.backend.offloader is not None else {}
    log(f"[plan] {len(outs)}/{SERVE_REQUESTS} requests finished; "
        f"{refused[0]} allocations refused (retried)")
    info.update(formula1_pages=formula1 / page_bytes,
                allocator_pages=[min(actual), max(actual)],
                n_microbatches=n_b, stage_time_ms=t_s * 1e3,
                h2d_gbps=h2d / 1e9, d2h_gbps=d2h / 1e9)
    del llm
    return counts, info


def yi_params(torch):
    """Full-width, full-depth yi-9b weights in bf16 from the seed, shared by
    the yi-9b serve phases."""
    from repro_torch.config import get_arch
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import Runtime
    cfg = get_arch("yi-9b")
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, SEED, rt, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in
                   [*params["embed"].values(), params["final_norm"]]
                   + [w for layer in params["layers"] for w in layer.values()])
    log(f"[serve] yi-9b full width and depth: {cfg.num_layers} layers, "
        f"{n_params / 1e9:.3f}B params bf16 from seed {SEED} in "
        f"{time.perf_counter() - t0:.1f}s")
    return params


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script measures the "
              "port on the card and has no CPU mode", file=sys.stderr)
        return 2
    import numpy as np

    smi_line, name = phase_card(torch)
    sass = phase_build()
    paged = phase_kernel_paged(torch, np)
    flash = phase_kernel_flash(torch, np)
    scan = phase_kernel_scan(torch, np)
    group_sizes = phase_group_sizes(torch, np)
    phase_parity(torch, np)
    swap_order = phase_swap_order(torch, np, smi_line)
    params = yi_params(torch)
    paths = {"yi-9b": phase_serve(torch, np, smi_line, params)}
    off_counts, offload = phase_serve_offload(torch, np, smi_line, params)
    paths.update({f"yi-9b {tag}": c for tag, c in off_counts.items()})
    paths["yi-9b planned"], plan = phase_plan(torch, np, smi_line, params)
    del params
    paths["gemma3-12b"] = phase_serve_gemma(torch, np, smi_line)
    paths["recurrentgemma-9b"] = phase_serve_recurrentgemma(torch, np,
                                                            smi_line)

    def launches(kernel):
        by_path = {path: c[kernel] for path, c in paths.items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    entries = [
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:206",
         "ok": True, **launches("paged_attention"), **paged,
         "group_sizes": group_sizes["paged"],
         "sass": sass["paged_attention"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:136",
         "ok": True, **launches("flash_attention"), **flash,
         "group_sizes": group_sizes["flash"],
         "sass": sass["flash_attention"]},
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan.py:54",
         "ok": True, **launches("rglru_scan"), **scan,
         "sass": sass["rglru_scan"]},
    ]
    print(json.dumps({"offload": {"swap_order": swap_order,
                                  "serve": offload, "plan": plan}}))
    print(json.dumps({"kernels": entries}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
