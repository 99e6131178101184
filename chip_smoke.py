#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, ``torch`` device name;
2. the build: every ``src/repro_torch/kernels/csrc/*.cu`` compiled with
   ``nvcc``, one process per source, all started together (paged
   attention, flash attention, the RG-LRU scan, the chunked-prefill
   attention), with each library's count
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
3b. the chunked-prefill attention kernel against its plain version (the
   gather of each row's whole table and ``models.attention
   .chunk_attention``) on the card, bf16 and float32, at both benchmark
   cells' chunk shapes (yi-9b heads, 256-token chunks over 4 rows of a
   4,096-slot table and 1 row of a 2,048-slot one), with partial chunks
   and a padding row; then its time (cold L2) beside the plain version's,
   an SDPA call over the gathered pages (``library_ms``) and the least
   time of its operations and bytes (``kernels.cost.chunk_cost``);
4. the flash-attention kernel against its plain version at gemma3-12b's
   prefill shapes (B=1, H=16, Hk=8, Dh=256, S from 8 to 2048, causal, with
   and without the 1024-token window), a sweep of Dh, G, non-causal and
   Sq != Skv, the bf16 kernel's tile edges (Sq, Skv in 127, 128, 129 at
   G = 1 and 16), bf16 and float32 with the same tolerances, every K/V the
   first Skv rows of a tensor whose tail is NaN; then the same four times
   (the kernel's with its TFLOP/s and the previous design's time);
   and at recurrentgemma-9b's local layers (B=1, H=16 over one kv head:
   G=16, Dh=256, causal, window 2048, S from 8 to 4096), with its times;
   and at yi-9b's fixed-batch prefill (B=4, S=512, H=32, Hk=4, Dh=128,
   causal, k and v the front of buffers whose tail is NaN), bf16 and
   float32, with its four times;
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
   states, rings); prompts past the window, more requests than slots; and
   the yi-shaped model (with and without its offloaded N_B = 4 pools) and
   the ``(local, global)`` model through the pipelined backend at N_S = 2;
7. the yi-9b serve phase: ``repro_torch.serving.llm.LLM`` on full-width,
   full-depth yi-9b in bf16 with random weights from the seed, 20 requests
   of 64-768 prompt tokens and 32 new tokens, greedy and sampled mixed;
   every request must finish at full length with finite log-probs, and the
   paged kernel's launch count must equal decode ticks x 48, and the
   chunked-prefill kernel's prefill chunks x 48;
   then, on the same weights and requests, the offloaded serve (4 x 4
   slots, 400 local pages and two global pools of 400 swapped through
   pinned host memory on the offloader's copy stream, beside an engine of
   1,200 local pages: every stream equal token for token, the swap books
   as the swaps imply, at least a quarter of the requests in global
   pages, no allocation refused) and the planned serve (the card's pinned
   copy rate and a measured stage time through ``EngineConfig.plan``,
   Formula 1's per-microbatch capacity printed beside the allocator's);
7g. the captured steps (``serving.step_graph``: every engine's decode
   tick and prefill call is a CUDA graph replay, one capture a key; an
   exact-prefill bucket's first call runs eagerly), held against the
   eager steps they replace on full-width yi-9b (bf16, the yi-9b phase's
   weights): the local decode step greedy and with sampled rows, the
   pipelined stages (2 x 24 layers) and the drain greedy and sampled, the
   local prefill chunk (8 rows x 32 tokens, the serve phase's) and the
   pipe's prefill stages and drain, two calls a key or more (the
   capturing one and replays with new inputs), each run eagerly on a copy
   of the caches and replayed on the live ones: tokens equal, logits and
   cache writes equal (bit-equal expected; a gap up to
   ``GRAPH_CACHE_ATOL`` is reported as cuBLAS rounding otherwise under
   capture), the largest log-prob, logit and cache gaps printed
   (``[graph-parity]``).  Phases 8 and 9 add one exact-prefill bucket
   each on their weights: three prompts of one bucket into three slots
   (the eager first call, the capturing call, a replay).  Every served
   path below prints a ``[graphs]`` line: its captures (each key once, or
   the phase fails; decode and prefill, the seconds spent capturing and
   instantiating), its replays (equal to its decode ticks, or its stage
   runs and drains; its prefill chunks, or prefill stage runs and
   drains, or exact prefills times stages less each bucket's eager first
   call), the host ms of a decode tick and of a prefill call (the
   engine's clocks), the replays' device ms a tick and a prefill replay
   (CUDA events), and the graphs' pool bytes;
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

10. the pipeline phase: §4.3's circular pipeline (``backend="pipelined"``)
   on full-width, full-depth yi-9b, the yi-9b phase's weights and 20
   requests: (1) 2 stages, N_B = 4, mb_size 4, fp32 wire, in-process
   links, the no-offload engine's pool: every stream equal to that local
   engine's token for token, the paged kernel launched 24 times a stage
   run, decode and prefill tok/s, and the host and device ms of one
   decode tick beside a local tick's; (2) the same with the offloaded
   pools, one offloader a stage: streams equal run 1's, swap books a
   stage; (3) 4 stages, int8 wire, 64 ms simulated links: every request
   at full length with finite log-probs, the transport's wire bytes equal
   to the packed payloads that crossed (``int8_wire_bytes``) plus the
   return trips, the share of greedy tokens equal to run 1's, and the
   admissions the straggler mitigation narrowed; (4) the
   latency curve at 64 ms with measured stage times: circular at the
   planner's N_B for run 1's stage time (at most 12) against round_flush
   at N_B = 2, N_B x 4 short greedy requests, each beside the simulator's
   round-time prediction; equal streams, and circular at least 3x
   round_flush's virtual decode tok/s (the JAX latency curve's floor).

6c. resilience parity, float32: phase 6's yi-shaped 2-layer model through
   a fault storm (2 stages, offloaded pools), a reshard 2 -> 1 mid-run and
   a prefix-cached online run; greedy streams identical on the CPU and the
   card, and each equal to its undisturbed run.

11. the resilience and online phase on full-width, full-depth yi-9b (the
   yi-9b phase's weights and 20 requests; reference: the local
   no-offload engine of the offload phase): (1) a fault storm, 2 stages,
   N_B = 4, mb_size 4, the offloaded pools: a fixed plan drops two
   prefill ticks, a decode tick at stage 0 and at stage 1 and the final
   drain, and delays stage 1 50 ms on 8 decode ticks; every stream equal,
   3 decode ticks and 2 chunks lost, the plan spent, extra ticks and wall
   against the pipeline phase's offloaded run; (2) a reshard 2 -> 4 -> 1
   mid-run, offloaded: streams equal, no token generated twice, the
   drain / export / rebuild / import seconds and GiB migrated; (3) a
   detector drill at 4 stages: the delayed stage 1 flagged and the
   prefill admission narrowed, device 3 silenced, a reshard to the
   planner's 2 stages, streams equal; (4) OnlineLLM over the local
   backend with a 512-token shared system prompt and the prefix cache,
   Poisson arrivals at 0.5x and 1.5x the yi-9b phase's offline request
   rate: streams equal an offline run without the cache, TTFT (from each
   request's scheduled arrival) and ITL p50 / p99 / max, prefix hit rate,
   prefill tokens skipped; (5) the same with
   the threaded pump and SLO admission: the budget fraction's minimum,
   close() in time.  Paged launches equal the stage runs x 48 / N_S at
   the stage count in force, or decode ticks x 48 on the local backend.

12. the trace phase: the flight recorder (``EngineConfig(trace=True)``)
   and the strict invariant auditor (``strict=True``) on full-width paths,
   each held against the untraced run of an earlier phase: (1)
   ``[trace-local]``, the yi-9b phase's engine and 20 requests six times
   in turns (off, on, strict, strict, on, off; "strict" is trace and
   strict): streams and paged launches equal the yi-9b phase's, decode and
   prefill tok/s, the recorder's events, drops and host µs a step, the
   auditor's checks and host ms a check; (2) ``[trace-pipe]``, 4 stages,
   int8 wire, 64 ms links, the offloaded pools: streams equal the
   pipeline phase's untraced int8 run, the recorded link ledger equal to
   the transport's books bitwise, the Chrome trace written to
   ``build/trace/`` (git-ignored), read back and valid, one swap window a
   swap, paged launches the stage runs x 12; (3) ``[trace-res]``, phase
   11's fault storm and 2 -> 4 -> 1 reshard traced and audited: streams
   equal, the recorded drops equal the lost ticks and chunks (3 + 2), one
   drain and one rebuild span a reshard, ``after_reshard`` passed each
   time; and, after the gemma3 phase, (4) ``[trace-gemma]``, the gemma3
   phase's engine traced and audited: streams, flash (960) and paged
   launches equal the gemma3 phase's.  The host costs are measured by
   wrapping each recording call and audit hook of the engine's instances
   with two ``perf_counter`` reads (the wrapper's own reads included).

13. the other architectures, bf16 unless stated: ``[arch-parity]``, a
   2-layer full-width phi3.5-moe (chunked prefill, paged decode) and an
   8-layer full-width xlstm-1.3b (exact prefill) in float32 on the card
   and on the CPU, 8 decode steps of the CPU's greedy tokens: routing ids
   equal, logits within ``ARCH_PARITY_TOL``, xlstm's first layer's states
   within ``XLSTM_STATE_TOL``, and the chunkwise mLSTM against the
   sequential one on the card at full width; ``[minitron]``, full
   minitron-4b (the paged kernel at G = 3); ``[xlstm]``, full xlstm-1.3b,
   20 requests over 8 slots (exact prefill in power-of-two buckets, every
   slot reset on reuse, no kernel launch); ``[moe-phi]``, phi3.5-moe at
   24 of 32 layers (62.9 GB) with the yi-9b phase's 20 requests, then
   through 2 stages; ``[moe-qwen3]``, qwen3-moe at 8 layers (128 experts,
   top 8, G = 16).  Each serve prints decode and prefill tok/s, a decode
   tick's host and device ms and busy share, and paged launches (ticks x
   layers, x 2 at G = 16; stage runs x 12 on the pipe); each MoE phase
   the dropped (token, choice) pairs and one tick's MoE split into
   router, dispatch, expert products and combine beside the weight-bytes
   bound; an ``{"archs": ...}`` JSON line.

14. the front ends and the training path: ``[flash-grad]``, the flash
   kernel's log-sum-exp output against the plain version's and
   ``FlashAttention``'s dq, dk, dv against autograd through the plain
   version at gemma3-1b's training shape (B=4, S=1024, 4 heads over 1 of
   256, causal and window 512) and recurrentgemma-9b's (B=2, S=2048, G=16,
   window 2048), float32 and bf16, timed with and without the LSE, the
   plain-torch backward beside SDPA's; ``[scan-grad]``, ``RGLRUScan``'s
   da, db, dh0 at B=2, S=2048, Dr=4096 against autograd through the plain
   loop, the reversed launch timed; ``[train-gemma3-1b]``, full-width,
   full-depth gemma3-1b trained as ``launch.train`` trains it (float32,
   batch 4 x 1024, 30 steps: the loss falls, flash launches steps x 26,
   tok/s, ms a step, peak GiB), then 20 steps checkpointed every 10 and
   resumed from step 10 by a fresh manager (steps 11-20's losses equal
   within ``TRAIN_RESUME_TOL``), then 20 int8-compressed steps;
   ``[train-rgemma]``, recurrentgemma-9b at full width, 3 layers, batch 2
   x 2048, 10 steps (scan launches steps x 2 layers x 2, flash steps x
   1); ``[frontend-musicgen]`` / ``[frontend-qwen2vl]``, both at full
   width and depth in bf16 through ``LLM.generate`` with the yi-9b
   phase's traffic (paged launches ticks x layers at G = 1 / Dh = 64 and
   G = 6 padded to 8); ``[frontend-parity]``, 2-layer full-width models
   in float32 on the CPU and the card: a ``{"frames"}`` prefill and a
   ``{"tokens", "patches"}`` prefill (256 patches), then 8 decode steps
   (qwen2-vl from S + P) through paged pools, so the card runs the paged
   kernel at both archs' head geometry; logits within ``FE_PARITY_TOL``
   of the CPU's dense and paged runs, greedy equal.  Phase 3 also holds
   the paged kernel to its plain version at both archs' serve shapes.

15. the fixed-batch passes of §4.3's circular pipeline
   (``core.pipeline.pipeline_prefill`` / ``pipeline_decode_step`` /
   ``pipeline_decode_rounds``), the §6 market and the examples:
   ``[fixed-pipe]``, full-width, full-depth yi-9b in bf16 on the yi-9b
   phase's weights, 2 stages of 24 layers, N_B = 4 microbatches of 4
   rows, 16 prompts of 512 tokens from the seed: the pipelined prefill's
   greedy tokens equal the plain ``model.prefill``'s run a microbatch at
   a time (the rows every stage call sees; max |logit difference| within
   ``FIXED_LOGIT_BOUND``), a decode step's equal ``decode_step``'s, 32
   rounds in one circular pass equal 32 sequential plain decode steps;
   the plain model over the whole batch in one call is reported beside
   it, not gated (its bf16 GEMMs of other shapes may round a near-tie the
   other way); flash launches N_B x 48 for one prefill and none in the
   decode passes (dense caches, the plain decode attention, as in the JAX
   passes); prefill ms, rounds tok/s beside the sequential decode's, the
   bubble share (N_S-1)/(R*N_B+N_S-1), peak GiB;
   ``[fixed-pipe-rgemma]``, recurrentgemma-9b at full width, its first 8
   layers (a period a stage, two rglru layers in the epilogue), N_B = 2 x
   2 rows of 1,024 tokens, 16 rounds: the same equalities, scan launches
   N_B x 4 + 2 and flash N_B x 2 for one prefill;
   ``[fixed-pipe-parity]``, phase 6's models in float32 (the yi-shaped
   one at 4 layers, ``(local, global)`` at 4, ``(rglru, rglru, local)``
   at 8), the passes on the CPU and the card: logits within ``FP_TOL``,
   greedy tokens and rounds equal; ``[market]``, the §6 protocol on
   served output: phase 10's run-1 streams (the miner) signed, verified
   and paid from an escrow each, every honest dispute against the local
   engine's streams dismissed, a result with one token changed slashed
   with the stake going to the owner, a third party's dispute refused;
   ``[examples]``, the five ``repro_torch.examples`` modules (and
   ``offline_serving`` pipelined) as subprocesses on the card, started
   together, each exiting 0 with its key lines (on the card their reduced
   models are widened to 64 a head, the kernels' smallest head dim).

16. the dry run (``repro_torch.launch.dryrun``): the whole table (every
   arch x ``SHAPES`` entry x one pod / two pods, traced on meta tensors,
   nothing allocated) runs in a subprocess started with the script, kept
   off the card, in ``DRYRUN_JOBS`` workers; this phase waits for it and
   checks every cell ok, or skipped where the JAX dry run skips it, and
   prints each cell's peak a device, whether one H100 holds it and its
   dominant roofline term (``[dryrun-table]`` lines).  Then three
   one-card cells, each predicted on meta by the same code and then run
   on the card under the same counters (``dryrun.check_cell``):
   ``[dryrun-prefill]``, full yi-9b ``model.prefill`` of 2 x 8,192 tokens
   in bf16 (48 flash launches a run); ``[dryrun-pipe]``, yi-9b
   ``pipeline_prefill`` and one ``pipeline_decode_step``, 2 stages, 4 x 4
   rows of 512 (phase 15's geometry, the same seed's weights); and
   ``[dryrun-train]``, one float32 ``train_step`` of full-depth gemma3-1b
   at 4 x 1,024 (flash with its LSE), on the allocator's expandable
   segments.  Each must have its argument bytes within 0.5% of
   ``memory_allocated``'s growth, the card's flops equal to
   the prediction, its predicted peak over ``max_memory_allocated``'s
   within [0.8, 1.25], and a step (host clock, synchronised) no faster
   than the roofline bound; each is run twice (counted, then timed).

17. pipeline stages placed by device (``EngineConfig(mesh=)``: each
   stage's weights, pools and offloader on its device, the activation
   handed card to card).  Phases 10, 11, 12 and 15 already ran through
   this one placement path with every stage on ``cuda:0``
   (``[multi-gpu-placement]``).  On any machine, ``[multi-gpu-mixed]``:
   yi-9b's widths at 4 layers in float32 from the seed, 2 stages, N_B =
   2, phase 6's parity requests, with ``mesh=["cuda:0", "cpu"]`` against
   ``["cuda:0", "cuda:0"]``: greedy streams equal on the fp32 and the
   int8 wire (the CPU stage takes the plain paged attention: the routing
   rule for a CPU tensor), each stage's single-sequence decode time on
   its device printed; and ``[multi-gpu-tied]``, gemma3-1b's widths at
   12 layers across the same boundary, the exact prefill walking the
   stages and the tied head's table a copy on the CPU, greedy streams
   equal ``["cuda:0", "cuda:0"]``'s.  Where ``torch.cuda.device_count()
   >= 2``: ``[multi-gpu-kernels]``, each kernel against its plain version
   on ``cuda:1`` (one shape each from phases 3-5); elsewhere ``[multi-gpu]
   1 card visible: the several-card runs did not run``.  The several-card
   serving runs would take the whole script past its limit, so only
   ``phase_multi_gpu_alone`` makes them: ``[multi-gpu-yi9b]``, phase 10's
   20 requests over ``cuda:0, cuda:1`` with an offloader a stage, streams
   equal the one-card pipe's on both wires; ``[multi-gpu-reshard]``, 2 ->
   1 -> 2 stages across the cards mid-run, the same streams, the GiB
   moved card to card and the seconds; ``[multi-gpu-fixed]``, phase 15's
   passes over both cards equal one card's bit for bit;
   ``[multi-gpu-phi3.5]``, full-depth phi3.5-moe (32 layers, 83.7 GB)
   over two cards, 20/20 with finite log-probs, each card's peak; and
   with four cards ``[multi-gpu-llama3]``, llama3-70b at full depth (141
   GB) over four.

Each serve phase sets every kernel's launch count to 0 just before it
drives its path and reads them just after; the kernels line reports those
counts by path.  A captured step's launches count at its replays (the
graph adds what its capture launched), so the counts are an eager
serve's.  Each phase prints ``[phase] <name>: start at <s>`` and its
seconds.

It prints an ``{"offload": ...}`` line (swap books, copy and wait times,
the planner's inputs), a ``{"pipeline": ...}`` line (the pipeline phase's
numbers and wall times), a ``{"resilience": ...}`` line (phase 11's), a
``{"trace": ...}`` line (phase 12's), an ``{"archs": ...}`` line
(phase 13's), a ``{"train": ...}`` line (phase 14's), a
``{"fixed_pipe": ...}`` line (phase 15's), a ``{"dryrun": ...}`` line
(phase 16's), a ``{"multi_gpu": ...}`` line (phase 17's: ``cards``,
``several_card_runs``, ``serving_runs``), a ``{"graphs": ...}`` line
(phase 7g's parity, every path's graph books, each phase's seconds and
the script's), a ``{"kernels": [...]}``
line, the card's
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  It exits non-zero without a
result when no CUDA device is visible.
"""

from __future__ import annotations

import json
from collections import Counter
import math
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import cost  # noqa: E402  (no torch import)

SEED = 0
# the H100's memory rate and peak rates by dtype, from kernels.cost (the
# one home of each kernel's work and of the card's rates)
HBM_BYTES_PER_S = cost.HBM_BYTES_PER_S
PEAK_FLOPS = cost.PEAK_FLOPS
YI_LAYERS = 48
KERNELS = ("paged_attention", "flash_attention", "rglru_scan",
           "chunk_attention")
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

# the pipelined yi-9b phase: two stages over the offloaded phase's 4 x 4
# slots and pools; four stages on an int8 wire over 64 ms simulated links;
# and the latency curve (circular at the planner's N_B, at most 12, against
# round_flush at N_B = N_S; short prompts and 64 new tokens, one admission
# wave, so the steady state dominates the virtual clock), whose
# ratio must reach the JAX latency curve's floor
PIPE_STAGES, PIPE_MB, PIPE_N_MB, PIPE_INT8_STAGES = 2, 4, 4, 4
PIPE_LINK = 0.064
PIPE_PROFILE_TICKS, PIPE_PROFILE_CTX = 10, 700
CURVE_MAX_NB, CURVE_PROMPTS, CURVE_NEW, CURVE_PAGES = 12, (16, 64), 64, 9
CURVE_FLOOR = 3.0
# the graph-parity phase: rows a microbatch, pages a row (of 16 tokens)
# and the context of the captured steps' ticks; a cache gap the replay may
# show against the eager step (bit-equal expected)
GRAPH_MB, GRAPH_PAGES, GRAPH_CTX = 4, 48, 700
GRAPH_CACHE_ATOL = 2 ** -5
# every served path's graph books (graph_books) and each phase's seconds,
# printed in the graphs line
GRAPH_BOOKS: dict = {}
# the exact-prefill buckets held against the eager step in phases 8 and 9
# (three prompts of one bucket each), also in the graphs line
EXACT_PARITY: dict = {}
GEMMA_PARITY_LENGTHS = (1328, 1321, 1325)       # bucket 1,328
RG_PARITY_LENGTHS = (1664, 1500, 1900)          # bucket 2,048
PHASE_SECONDS: dict = {}
# phase 11 (resilience and online serving): the fault storm's pipe, its
# delayed ticks and its drops, the reshard steps (2 -> 4, then -> 1), the
# detector drill's silenced step and timeout (in steps), the online runs'
# shared system prompt, pages a sequence and TTFT target.  The pipe's
# schedule follows from the host bookkeeping alone (prompt lengths, slots,
# pools, chunk budget; two stages never flag a straggler), so the drops
# are fixed tick indices where the stage holds an entry: prefill ticks 3
# and 5 and decode ticks 40 and 70 run both stages, and decode tick 294 is
# the run's final drain, which only stage 1 holds.  The run fails unless
# all five come back lost.
RES_STAGES = 2
RES_DELAY_S, RES_DELAY_FROM, RES_DELAY_TICKS = 0.050, 4, 8
RES_DROPS = ("drop@prefill:3:0", "drop@prefill:5:1", "drop@decode:40:0",
             "drop@decode:70:1", "drop@decode:294:1")
RES_RESHARD_STEPS = (60, 150)
RES_KILL_STEP, RES_TIMEOUT = 60, 3
RES_SYSTEM, RES_ONLINE_MAX_PAGES, RES_SLO_TTFT = 512, 96, 2.0
# phase 12 (the flight recorder and the strict auditor): the local runs'
# turns, and where the traced pipeline's Chrome trace is written
TRACE_TURNS = ("off", "on", "strict", "strict", "on", "off")
TRACE_DIR = ROOT / "build" / "trace"
# phase 13 (the other architectures).  phi3.5-moe at 24 of its 32 layers
# (full depth is 83.7 GB of bf16 weights, more than the card holds; 24
# layers are 62.9 GB) and qwen3-moe at 8 of 94 (42.3 GB), served with the
# yi-9b phase's 20 requests over its 16 slots (phi also through 2 stages
# of 8 x 2 slots); xlstm-1.3b and minitron-4b at full depth; each path's
# decode tick profiled at a 512-token context, and each MoE tick's split
# timed over MOE_SPLIT_REPS ticks after a spin that lets the host issue a
# whole tick first.  The parity models: a 2-layer phi and an 8-layer
# xlstm (one pattern period), float32, card vs CPU.
PHI_LAYERS, QWEN_LAYERS = 24, 8
MOE_MB, MOE_PAGE, MOE_MAX_PAGES = 16, 16, 64
MOE_PIPE_MB, MOE_PIPE_N_MB = 8, 2
MOE_SPLIT_REPS, MOE_SPLIT_SPIN_CYCLES = 5, 100_000_000
XL_MB, XL_REQUESTS, XL_PROMPTS, XL_NEW = 8, 20, (32, 256), 32
MT_MB, MT_REQUESTS, MT_PROMPTS, MT_NEW = 8, 8, (64, 512), 16
ARCH_TICK_CTX, ARCH_TICK_STEPS = 512, 10
PARITY_ROWS, PARITY_PROMPT, PARITY_STEPS = 2, 48, 8
# logits, card vs CPU, float32.  xlstm's is looser: h = num / den
# magnifies a rounding difference where den is small, and each layer of
# the random-init model multiplies it again (chip run 3 of PR 20: 2.1e-2
# of logits up to 5 after 8 layers, argmax all equal; the layers' state
# errors grow from 1.9e-6 to 1.0e-2), so its first mLSTM layer's states
# are also held at XLSTM_STATE_TOL relative
ARCH_PARITY_TOL = {"phi3.5-moe-42b-a6.6b": 1e-3, "xlstm-1.3b": 5e-2}
XLSTM_STATE_TOL = 1e-4
MLSTM_CARD_S, MLSTM_CARD_TOL = 200, 1e-4   # relative to max |h|, max |C|
# phase 14 (the front ends and the training path).  [flash-grad]: the
# training shapes of gemma3-1b (B = 4, S = 1024, 4 heads over 1 of 256;
# causal global layers, local layers in a 512 window) and of
# recurrentgemma-9b's local layers (B = 2, S = 2048, 16 over 1, window
# 2048), float32 and bf16
FLASH_GRAD_SHAPES = (("gemma3-1b", 4, 1024, 4, 1, 256, (0, 512)),
                     ("recurrentgemma-9b", 2, 2048, 16, 1, 256, (2048,)))
# the kernel's log-sum-exp against the plain version's, (atol, rtol): both
# sum float32 scores of the same products in other orders (the bf16 kernel
# in base 2), for values up to about 10
LSE_TOL = (1e-4, 1e-5)
# FlashAttention's dq, dk, dv against autograd through the plain version,
# as a share of each gradient's max |g|: float32 within 1e-4 (summation
# order); bf16 within 2e-2, because the backward reads the kernel's bf16
# output (8 mantissa bits) in rowsum(dout * out) where autograd through the
# plain version has the float32 softmax, and the gradients round to bf16
FLASH_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# [scan-grad]: RGLRUScan at B = 2, S = 2048, Dr = 4096, float32, against
# autograd through the plain loop, as a share of each gradient's max |g|
# (the reversed kernel and the loop's backward sum each step's two terms
# in the same float32 operations, so only rounding order can differ)
SCAN_GRAD_SHAPE = (2, 2048, 4096)
SCAN_GRAD_TOL = 1e-5
# [train-gemma3-1b]: full width and depth through the CLI's setup
# (``launch.train.setup``: float32, AdamW at 3e-3, seed 0), batch 4 x 1024;
# then 20 steps with a checkpoint every 10, resumed from step 10 by a fresh
# manager (steps 11-20's losses within TRAIN_RESUME_TOL relative: the CUDA
# embedding backward accumulates with atomics, so it is not bitwise
# deterministic); then 20 steps through the int8 compressor
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 30
TRAIN_RESUME_STEPS, TRAIN_CKPT_EVERY, TRAIN_RESUME_TOL = 20, 10, 1e-4
TRAIN_COMPRESS_STEPS = 20
TRAIN_CKPT_DIR = ROOT / "build" / "ckpt"
# each graphed run (step 1 eager, then replays) is held to this many steps
# of the functional step run eagerly on the same weights and batches
TRAIN_EAGER_STEPS = 3
# [train-rgemma]: recurrentgemma-9b at full width, its first 3 layers
# (rglru, rglru, local), float32, batch 2 x 2048
RG_TRAIN_LAYERS, RG_TRAIN_BATCH, RG_TRAIN_SEQ, RG_TRAIN_STEPS = 3, 2, 2048, 10
# [frontend-parity]: full width at 2 layers, float32, card vs CPU: a prefill
# of 48 audio frames / 48 tokens after 256 patches, then 8 greedy decode
# steps through paged pools; logits within FE_PARITY_TOL (float32 sums in
# other orders)
FE_PARITY_LAYERS, FE_PARITY_S, FE_PARITY_STEPS, FE_PARITY_TOL = 2, 48, 8, 1e-4
# [fixed-pipe]: full yi-9b through the fixed-batch passes, 2 stages of 24
# layers, N_B microbatches of mb rows, prompts of S tokens, R greedy rounds
FIXED_STAGES, FIXED_N_MB, FIXED_MB, FIXED_S = 2, 4, 4, 512
FIXED_CAP, FIXED_R = 576, 32
# the pipelined prefill's and decode step's logits against the plain model
# run a microbatch at a time, relative to the largest |logit|: every layer
# sees the stage calls' rows, but the final norm and the unembedding run
# over the whole batch in the passes (the JAX passes' epilogue) and over a
# microbatch in the plain calls, so that GEMM may round a bf16 logit by
# one ulp (at most 2^-7 of the value); the bound allows two
FIXED_LOGIT_BOUND = 2 ** -6
# [fixed-pipe-rgemma]: recurrentgemma-9b at full width, its first 8 layers
# (a (rglru, rglru, local) period a stage, an epilogue of 2 rglru layers)
RG_FIXED_LAYERS, RG_FIXED_N_MB, RG_FIXED_MB, RG_FIXED_S = 8, 2, 2, 1024
RG_FIXED_CAP, RG_FIXED_R = 1056, 16
# [fixed-pipe-parity]: phase 6's models, float32, CPU vs card
FP_N_MB, FP_MB, FP_S, FP_CAP, FP_R, FP_TOL = 2, 2, 40, 64, 8, 1e-4
# [market]: the miner's stake and the price a result
MARKET_STAKE, MARKET_PRICE = 80.0, 1.0
# [examples]: each module with small arguments, and the lines it prints
EXAMPLES = {
    "quickstart": ([], ("registered architectures:", "engine report:",
                        "N_B* = ")),
    "offline_serving": (["--requests", "8", "--max-new", "8"],
                        ("served 8 requests", "tok/s on cuda")),
    "offline_serving --backend pipelined": (
        ["--arch", "yi-9b", "--backend", "pipelined", "--stages", "2",
         "--requests", "8", "--max-new", "8"],
        ("[pipelined]: served 8 requests",)),
    "networked_serving": ([], ("outputs bit-identical across all three",
                               "int8 wire codec:")),
    "train_small": (["--steps", "20"], ("loss: ", "on cuda")),
    "decentralized_market": ([], ("payment released:", ": dismissed",
                                  "miner7: slashed")),
}
EXAMPLE_TIMEOUT_S = 300

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
    from repro_torch.serving.step_graph import counted_kernels
    return counted_kernels()


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
    """Least time for the work (``kernels.cost.paged_cost``): K and V rows
    each read once for the tokens attended, q / table / lengths read once,
    out written once; and the flops 4 * H * Dh per token over the peak
    rate of the dtype.  Returns (ms, what bounds it, bytes)."""
    flops, nbytes = cost.paged_cost(case_lens, window, h, hk, dh, esize, b,
                                    max_pages)
    return (*cost.least_ms(flops, nbytes, dtype_name), nbytes)


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
    for d, card_line in enumerate(smi.strip().splitlines()):
        log(f"[card] nvidia-smi: {card_line}" if d == 0 else
            f"[card] nvidia-smi, card {d}: {card_line}")
    return line, name


def sass_functions(path) -> dict:
    """The library's SASS by ``cuobjdump -sass`` from ``$CUDA_HOME/bin``:
    each function's opcodes in order, by its mangled name; None when the
    tool is absent or fails (the counts report the design, they decide
    nothing)."""
    import os
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                "cuobjdump")
    if not tool.exists():
        return None
    res = subprocess.run([str(tool), "-sass", str(path)], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        return None
    funcs, ops = {}, None
    for ln in res.stdout.splitlines():
        words = ln.split()      # /*1a90*/ [@P0] OPCODE.MODIFIERS ...
        if len(words) == 3 and words[:2] == ["Function", ":"]:
            ops = funcs.setdefault(words[2], [])
        elif ops is not None and len(words) > 2 and \
                re.fullmatch(r"/\*[0-9a-f]+\*/", words[0]):
            op = words[2] if words[1].startswith("@") else words[1]
            ops.append(op.split(".")[0])
    return funcs


def sass_counts(funcs) -> dict:
    """How many of each of ``SASS_OPS`` all of ``sass_functions``' hold."""
    if funcs is None:
        return None
    ops = [op for body in funcs.values() for op in body]
    return {op: ops.count(op) for op in SASS_OPS}


def ptxas_registers(log_text: str) -> dict:
    """Registers each entry function uses, by mangled name, from the
    ``-Xptxas -v`` log."""
    regs, fn = {}, None
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn is not None:
            regs[fn] = int(m.group(1))
            fn = None
    return regs


def flash_lse_instances(funcs, regs) -> dict:
    """The bf16 flash kernel's two instances for each (Dh, G), the serving
    one (kLse false) and the training one that also writes the LSE (kLse
    true), side by side: registers, SASS instructions and the opcodes
    whose counts differ, printed for the two training shapes (Dh 256 at G
    4 and 16) and summed up over the rest."""
    pat = re.compile(r"flash_fwd_wgmma_kernelILi(\d+)ELi(\d+)ELb([01])E")
    by = {}
    for name, body in (funcs or {}).items():
        m = pat.search(name)
        if m:
            key = (int(m.group(1)), int(m.group(2)))
            by.setdefault(key, {})[m.group(3) == "1"] = (body,
                                                         regs.get(name))
    out = {}
    for (dh, g), pair in sorted(by.items()):
        if len(pair) != 2:
            continue
        (serve, r0), (train, r1) = pair[False], pair[True]
        c0, c1 = Counter(serve), Counter(train)
        diff = {op: c1[op] - c0[op] for op in set(c0) | set(c1)
                if c1[op] != c0[op]}
        out[f"dh{dh}_g{g}"] = {"registers": [r0, r1],
                               "instructions": [len(serve), len(train)],
                               "opcode_diff": diff}
        if dh == 256 and g in (4, 16):
            top = sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:12]
            log(f"[build] flash bf16 Dh={dh} G={g}: serving instance "
                f"{r0} registers, {len(serve)} SASS instructions; kLse "
                f"instance {r1} registers, {len(train)} "
                f"({len(train) - len(serve):+d}: "
                + ", ".join(f"{op} {n:+d}" for op, n in top) + ")")
    if out:
        deltas = [v["instructions"][1] - v["instructions"][0]
                  for v in out.values()]
        log(f"[build] flash bf16 kLse instances over all {len(out)} (Dh, G):"
            f" {min(deltas):+d} to {max(deltas):+d} SASS instructions "
            f"beside the serving ones; registers equal in "
            f"{sum(v['registers'][0] == v['registers'][1] for v in out.values())}"
            f"/{len(out)}")
    else:
        log("[build] flash bf16 instances: no SASS to compare (cuobjdump "
            "absent from $CUDA_HOME/bin)")
    return out


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
        funcs = sass_functions(info.path)
        sass[name] = sass_counts(funcs)
        if name == "flash_attention":
            sass["flash_lse_instances"] = flash_lse_instances(
                funcs, ptxas_registers(info.log))
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
    # the front ends' decode shapes as their serve phases (14) give them:
    # musicgen-large's 32 heads over 32 of 64 (G = 1) and qwen2-vl-2b's 12
    # over 2 of 128 (G = 6, each group padded to 8 by kernels/groups.py),
    # at the serve phase's batch, table and pool, its context lengths, an
    # empty row and an idle one (1 token on scratch page 0)
    from repro_torch.config import get_arch
    for arch in ("musicgen-large", "qwen2-vl-2b"):
        fc = get_arch(arch)
        sl = rng.randint(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + SERVE_NEW + 1,
                         SERVE_MB)
        sl[2], sl[9] = 0, SERVE_PROMPTS[1] + SERVE_NEW
        for dtype in (torch.bfloat16, torch.float32):
            args = paged_case(torch, np, rng, b=SERVE_MB, h=fc.num_heads,
                              hk=fc.num_kv_heads, dh=fc.head_dim,
                              page=SERVE_PAGE, max_pages=SERVE_MAX_PAGES,
                              lens=sl, dtype=dtype, device=dev,
                              pool_pages=SERVE_POOL_PAGES)
            q, kp, vp, pt, sl_t = args
            pt[7], sl_t[7] = 0, 1
            kp[0, 0], vp[0, 0] = torch.randn(
                (2, fc.num_kv_heads, fc.head_dim), device=dev).to(dtype)
            check(f"{arch} decode shapes {str(dtype).split('.')[-1]} (H="
                  f"{fc.num_heads} Hk={fc.num_kv_heads} Dh={fc.head_dim}, "
                  f"table {tuple(pt.shape)}, pool {tuple(kp.shape)})",
                  args, 0)
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


# the chunked-prefill attention against its plain version: as in
# tests/test_torch_chunk_attention.py, float32 at TOL and bf16 within
# 2**-8 max|V| (P rounded to bf16 at the running max, not the final one)
# and one bf16 ulp
CHUNK_BF16_TOL = (2 ** -8, 2 ** -7)
# the benchmark cells' chunk shapes (bench/configs/yi9b.json, bench/cells):
# rows of 256 tokens, yi-9b's heads, page 16; offsets near prefill_heavy's
# mean prompt (log-uniform 1,024-3,968) and decode_heavy's (128-1,024)
CHUNK_CELLS = {"yi9b.prefill_heavy": dict(b=4, max_pages=256,
                                          offsets=(2048,) * 4),
               "yi9b.decode_heavy": dict(b=1, max_pages=128,
                                         offsets=(512,))}


def chunk_case(torch, np, rng, *, b, c, h, hk, dh, page, max_pages, offsets,
               n_valid, dtype, device):
    """Random pools in which each row's table holds pages of its own (page
    0 is scratch), all finite: a padded query's value and the plain
    version's P.V read every slot of the table.  Positions ``offset + i``
    for a row's first ``n_valid`` queries, -1 after."""
    n_pool = 1 + b * max_pages
    pt = rng.permutation(np.arange(1, n_pool)).astype(np.int32).reshape(
        b, max_pages)
    pos = np.full((b, c), -1, np.int32)
    for r in range(b):
        pos[r, :n_valid[r]] = offsets[r] + np.arange(n_valid[r])
    q = torch.randn((b, c, h, dh), device=device)
    kp = torch.randn((n_pool, page, hk, dh), device=device)
    vp = torch.randn((n_pool, page, hk, dh), device=device)
    return (q.to(dtype), kp.to(dtype), vp.to(dtype),
            torch.from_numpy(pt).to(device), torch.from_numpy(pos).to(device))


def chunk_sdpa(torch, q, kp, vp, pt, pos):
    """The yardstick for a chunk: one SDPA call over each row's table
    gathered into contiguous (B, Hk, T, Dh) tensors with the position mask
    (the gather is made here, outside the timed call)."""
    b, t = pt.shape[0], pt.shape[1] * kp.shape[1]
    hk, dh = kp.shape[2], kp.shape[3]
    kv_pos = torch.arange(t, device=q.device)
    mask = (kv_pos[None, None] <= pos[:, :, None].long())[:, None]
    kg, vg = (x[pt.long()].reshape(b, t, hk, dh).transpose(1, 2).contiguous()
              for x in (kp, vp))
    qt = q.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qt, kg, vg, attn_mask=mask, enable_gqa=True)


def phase_kernel_chunk(torch, np):
    from repro_torch.kernels import chunk_attention as ca
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 31)
    torch.manual_seed(SEED + 31)
    H, HK, DH, PAGE, C = 32, 4, 128, 16, 256

    def check(label, args):
        got = ca.paged_chunk_attention(*args)
        torch.cuda.synchronize()
        want = ref.paged_chunk_attention_ref(*args)
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{label}: non-finite kernel output")
        if args[0].dtype == torch.float32:
            atol, rtol = TOL["float32"]
        else:
            atol = CHUNK_BF16_TOL[0] * args[2].float().abs().max().item()
            rtol = CHUNK_BF16_TOL[1]
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol, msg=lambda m: f"{label}: {m}")
        log(f"[kernel-chunk] {label}: max |kernel - plain| = {err:.3e} "
            f"(atol {atol:.3g}, rtol {rtol:g}) ok")
        return err

    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    out = {}
    for cell, shape in CHUNK_CELLS.items():
        b, maxp = shape["b"], shape["max_pages"]
        t = maxp * PAGE
        kw = dict(b=b, c=C, h=H, hk=HK, dh=DH, page=PAGE, max_pages=maxp)
        # offsets 0, the cell's, and the chunk reaching the table's end;
        # partial chunks and (with several rows) a padding row
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            for offs, valid in ((shape["offsets"], (C,) * b),
                                ((0,) * b, (C,) * b),
                                ((t - C,) + (t // 3,) * (b - 1),
                                 (C,) + (C // 2 + 7,) * (b - 1)),
                                ((37,) * b, (C - 101,) + (0,) * (b - 1))):
                check(f"{cell} B={b} table {t} offsets {offs[:2]} n_valid "
                      f"{valid[:2]} {name}",
                      chunk_case(torch, np, rng, **kw, offsets=offs,
                                 n_valid=valid, dtype=dtype, device=dev))
        # times at the cell's shape, bf16, every query real
        args = chunk_case(torch, np, rng, **kw, offsets=shape["offsets"],
                          n_valid=(C,) * b, dtype=torch.bfloat16,
                          device=dev)
        err = check(f"{cell} timed case", args)
        ms = time_ms(torch, lambda: ca.paged_chunk_attention(*args), 50,
                     flush)
        plain_ms = time_ms(torch, lambda: ref.paged_chunk_attention_ref(
            *args), 10, flush)
        library_ms = time_ms(torch, chunk_sdpa(torch, *args), 20, flush)
        flops, nbytes = cost.chunk_cost(args[4].tolist(), H, HK, DH, 2, maxp,
                                        PAGE)
        bound_ms, bound_by = cost.least_ms(flops, nbytes, "bfloat16")
        log(f"[kernel-chunk] times at {cell}: B={b} C={C} H={H} Hk={HK} "
            f"Dh={DH} page={PAGE} table {t} offsets {shape['offsets'][0]} "
            f"bf16, cold L2: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms(sdpa)={library_ms:.4f} bound_ms={bound_ms:.4f} "
            f"({bound_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); "
            f"kernel at {bound_ms / ms:.1%} of the bound, "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
        out[cell] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "flops": flops, "bytes": nbytes}
    return out


def flash_bound(sq, skv, causal, window, h, hk, dh, esize, dtype_name,
                b=1):
    """Least time for the work (``kernels.cost.flash_cost``): the live
    (query, key) pairs cost 4 * Dh flops a head over the peak rate of the
    dtype; q, k, v read once and the output written once over the memory
    rate, for each of ``b`` rows.  The larger wins.  Returns (ms, what
    bounds it, flops)."""
    flops, nbytes = cost.flash_cost(b, sq, skv, h, hk, dh, causal, window,
                                    esize)
    return (*cost.least_ms(flops, nbytes, dtype_name), flops)


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

    # yi-9b's fixed-batch prefill (phase 15): one launch a microbatch of
    # FIXED_MB rows of FIXED_S tokens, 32 heads over 4 kv heads of 128,
    # causal; k and v each the front of a flat buffer whose tail is NaN
    def batched_case(b, s_len, h, hk, dh, dtype):
        q = torch.randn((b, s_len, h, dh), device=dev).to(dtype)
        kv = []
        for _ in range(2):
            n = b * s_len * hk * dh
            flat = torch.randn((n + 64 * hk * dh,), device=dev)
            flat[n:] = float("nan")
            kv.append(flat.to(dtype)[:n].view(b, s_len, hk, dh))
        return q, kv[0], kv[1]

    yi_fixed = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = batched_case(FIXED_MB, FIXED_S, 32, 4, 128, dtype)
        err = check(f"yi-9b fixed-batch prefill B={FIXED_MB} S={FIXED_S} "
                    "H=32 Hk=4 Dh=128 causal", args, True, 0)
        if dtype == torch.bfloat16:
            yi_fixed = {"args": args, "err": err}

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
    # the same four times at yi-9b's fixed-batch prefill shape
    q, k, v = yi_fixed["args"]
    b, s_len = q.shape[:2]
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True),
                 20)
    plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(
        q, k, v, causal=True), 5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                             enable_gqa=True), 20)
    bound_ms, bound_by, flops = flash_bound(s_len, s_len, True, 0, 32, 4,
                                            128, 2, "bfloat16", b=b)
    log(f"[flash] times at yi-9b fixed-batch prefill B={b} S={s_len} H=32 "
        f"Hk=4 Dh=128 causal bf16: kernel_ms={ms:.4f} plain_ms="
        f"{plain_ms:.4f} library_ms(sdpa)={library_ms:.4f} bound_ms="
        f"{bound_ms:.4f} ({bound_by}); kernel at {bound_ms / ms:.1%} of the "
        f"bound, {flops / ms / 1e9:.1f} TFLOP/s")
    yi_times = {"max_abs_err": yi_fixed["err"], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}
    return {**times[0], "window_1024": times[1024],
            "recurrentgemma_prefill": rg_times,
            "yi9b_fixed_prefill": yi_times}


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
        bound_ms, bound_by = cost.least_ms(*cost.scan_cost(b, s_len, dr),
                                           "float32")
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
    (local, global) model and of an (rglru, rglru, local) model; and the
    yi-shaped model (with and without its offloaded pools) and the
    (local, global) model through the pipelined backend at N_S = 2."""
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
    # 31 local pages and two global pools of 64 over 4 x 4 slots:
    # microbatches 0 and 2 share G0 and swap it every tick
    offload_pool = dict(mb_size=4, num_microbatches=4, pool=PoolConfig(
        page_size=16, n_local_pages=32, n_global_pages=64,
        max_pages_per_seq=16))
    pipe = dict(backend="pipelined", n_stages=2)
    gemma_lg = dataclasses.replace(
        get_arch("gemma3-12b"), name="gemma3-local-global",
        num_layers=4, block_pattern=("local", "global"), d_model=512,
        num_heads=8, num_kv_heads=4, head_dim=64, d_ff=1024,
        vocab_size=2048, window_size=32)
    models = {
        # chunked prefill, the paged kernel
        "yi-9b-2layer": (yi2, (20, 200), True, local_pool),
        "yi-9b-2layer-offload": (yi2, (20, 200), True, offload_pool),
        # exact prefill through the flash kernel (both layers; head_dim 64
        # so the kernels take it), a 32-slot ring, the paged kernel
        "gemma3-local-global": (gemma_lg, (20, 101), False, local_pool),
        # exact prefill through the scan kernel (3 rglru layers) and the
        # flash kernel at G = 16 (the local layer), recurrent states reset
        # as 10 requests pass through 8 slots, a 32-slot ring
        "recurrentgemma-rglru-local": (dataclasses.replace(
            get_arch("recurrentgemma-9b"), name="recurrentgemma-rglru-local",
            num_layers=4, d_model=512, d_rnn=512, num_heads=16,
            num_kv_heads=1, head_dim=64, d_ff=1024, vocab_size=2048,
            window_size=32), (20, 101), False, local_pool),
        # the pipelined backend, N_S = 2: one layer a stage (chunked
        # prefill and the paged kernel through both prefill and decode
        # pipes; with per-stage offloaders at N_B = 4), and one period of
        # (local, global) a stage with exact prefill outside the pipe
        "yi-9b-2layer-pipelined": (yi2, (20, 200), True,
                                   {**local_pool, **pipe}),
        "yi-9b-2layer-offload-pipelined": (yi2, (20, 200), True,
                                           {**offload_pool, **pipe}),
        "gemma3-local-global-pipelined": (gemma_lg, (20, 101), False,
                                          {**local_pool, **pipe}),
    }
    sp = SamplingParams(temperature=0.0, max_new_tokens=16)
    for label, (cfg, (lo, hi), chunked, layout) in models.items():
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
    spans = time_replays(torch, llm.engine.backend)
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
    chunks = llm.engine.backend.prefill_chunks
    graph_books(torch, "serve", llm.engine.backend, rep, spans)
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
    if chunks == 0 or counts["chunk_attention"] != chunks * YI_LAYERS:
        raise AssertionError(f"serve: {counts['chunk_attention']} chunk "
                             f"kernel launches for {chunks} prefill chunks x "
                             f"{YI_LAYERS} layers")
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
        f"(= {ticks} x {YI_LAYERS}); prefill chunks {chunks}, chunk-kernel "
        f"launches {counts['chunk_attention']} (= {chunks} x {YI_LAYERS})")
    return counts, wall, outs


def _clone_caches(caches) -> dict:
    """A copy of engine caches: every layer's tensors and the page table
    (its per-device copies too)."""
    out = {"layers": [{k: t.clone() for k, t in layer.items()}
                      for layer in caches["layers"]],
           "page_table": caches["page_table"].clone()}
    if "page_tables" in caches:
        out["page_tables"] = {d: t.clone()
                              for d, t in caches["page_tables"].items()}
    return out


def _cache_gap(torch, got, want) -> tuple:
    """(leaves that differ, largest absolute gap) between two caches."""
    n, gap = 0, 0.0
    for g, w in zip(got["layers"], want["layers"]):
        for name in g:
            if not torch.equal(g[name], w[name]):
                n += 1
                gap = max(gap, (g[name].float() - w[name].float()).abs()
                          .max().item())
    return n, gap


def _graph_samp(np, mb: int, step: int, sampled: bool):
    """Every row greedy, or rows 1 and 3 sampled (the serve phases'
    temperature 0.8, top-k 50, top-p 0.95) beside greedy rows 0 and 2."""
    from repro_torch.serving.sampler import RowSampling
    temp = np.zeros((mb,), np.float32)
    if sampled:
        temp[1::2] = 0.8
    return RowSampling(keys=np.arange(mb, dtype=np.int64) + 11,
                       steps=np.full((mb,), step, np.int32), temp=temp,
                       top_k=np.where(temp > 0, 50, 0).astype(np.int32),
                       top_p=np.where(temp > 0, 0.95, 1.0).astype(np.float32))


def _graph_check(torch, tag, got_toks, got_lps, want_toks, want_lps, be,
                 ref, gaps):
    """Hold one replayed tick against the eager one: equal tokens, cache
    writes equal (bit-equal expected; a gap within GRAPH_CACHE_ATOL is
    reported as cuBLAS rounding otherwise under capture, beyond it fails);
    the largest log-prob and cache gaps are kept in ``gaps``."""
    want_toks = want_toks.cpu().numpy()
    want_lps = want_lps.float().cpu().numpy()
    if not (got_toks == want_toks).all():
        raise AssertionError(f"graph-parity {tag}: replayed tokens "
                             f"{got_toks.tolist()} != eager "
                             f"{want_toks.tolist()}")
    lp_gap = float(abs(got_lps - want_lps).max())
    n, gap = _cache_gap(torch, be.caches, ref)
    if gap > GRAPH_CACHE_ATOL:
        raise AssertionError(f"graph-parity {tag}: {n} cache leaves differ "
                             f"from the eager step's by up to {gap}")
    gaps.append({"tick": tag, "logprob_gap": lp_gap, "cache_leaves": n,
                 "cache_gap": gap})
    note = "bit-equal" if n == 0 and lp_gap == 0 else \
        "not bit-equal (cuBLAS rounds otherwise under capture)"
    log(f"[graph-parity] {tag}: tokens equal; max |logprob gap| "
        f"{lp_gap:.3e}; cache leaves differing {n}, max gap {gap:.3e}: "
        f"{note}")


def phase_graph_parity(torch, np, card: str, params, cfg=None,
                       dev=None) -> dict:
    """Each captured decode step of full-width yi-9b (bf16, 48 layers, the
    serve phase's weights) held against the eager step it replaces: the
    local step (greedy, then mixed greedy and sampled rows) and the
    pipelined stages (2 x 24 layers) and drain (greedy and sampled), two
    ticks a key (the capturing tick and a replay with new inputs), each
    as an eager step on a copy of the caches and as a replay on the live
    ones; ``GRAPH_MB`` rows a microbatch at about ``GRAPH_CTX`` tokens in
    their own pages, random pools.  ``cfg`` and ``dev`` rehearse it at
    another size or on the CPU (where both sides run eagerly)."""
    from repro_torch.config import get_arch
    from repro_torch.core import pipeline as PL
    from repro_torch.models.common import Runtime
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.backend import LocalBackend, PipelinedBackend
    from repro_torch.serving.sampler import gumbel_noise

    cfg = cfg or get_arch("yi-9b")
    dt = next(iter(params["embed"].values())).dtype
    rt = Runtime(param_dtype=dt, compute_dtype=dt)
    dev = dev or torch.device("cuda", 0)
    mb, n_b = GRAPH_MB, 2
    pool = kvc.PoolConfig(page_size=SERVE_PAGE,
                          n_local_pages=mb * n_b * GRAPH_PAGES + 1,
                          max_pages_per_seq=GRAPH_PAGES)
    table = 1 + np.arange(mb * n_b * GRAPH_PAGES,
                          dtype=np.int32).reshape(mb * n_b, GRAPH_PAGES)
    rng = np.random.RandomState(SEED)
    gen = torch.Generator(device=dev)
    gaps: list = []
    out = {}

    def fresh(be):
        kvc.set_page_table(be.caches, table)
        g = torch.Generator(device=dev).manual_seed(SEED)
        for layer in be.caches["layers"]:
            for name in ("k_pages", "v_pages"):
                layer[name].copy_(torch.randn(layer[name].shape, generator=g,
                                              device=dev) * 0.5)
        return be

    def inputs(step):
        toks = rng.randint(1, cfg.vocab_size, mb).astype(np.int32)
        pos = (GRAPH_CTX - 40 + rng.randint(0, 40, mb) + step).astype(
            np.int32)
        return toks, pos

    def samp_t(samp):
        return [torch.from_numpy(a).to(dev)
                for a in (samp.temp, samp.top_k, samp.top_p)]

    with torch.inference_mode():
        # the local step: (mb 0, greedy) and (mb 1, sampled), two ticks each
        be = fresh(LocalBackend(cfg, params, rt, mb_size=mb,
                                num_microbatches=n_b, pool=pool, device=dev))
        ref = _clone_caches(be.caches)
        for m, sampled in ((0, False), (1, True)):
            for step in range(2):
                toks, pos = inputs(step)
                samp = _graph_samp(np, mb, step, sampled)
                noise = gumbel_noise(samp, cfg.vocab_size, dev, gen) \
                    if sampled else None
                want = LocalBackend._decode_fn(
                    params, ref, torch.from_numpy(toks).to(dev),
                    torch.from_numpy(pos).to(dev), m * mb, noise,
                    *samp_t(samp), cfg=cfg, rt=rt, mb_size=mb,
                    sampled=sampled)
                (res,) = be.decode(m, toks, pos, samp)
                _graph_check(torch, f"local mb {m} "
                             f"{'sampled' if sampled else 'greedy'} tick "
                             f"{step}", res.tokens, res.logprobs, *want, be,
                             ref, gaps)
        out["local"] = be.graphs.stats()
        del be, ref

        # the pipelined steps: 2 stages, fill, steady state, drain
        be = fresh(PipelinedBackend(cfg, params, rt, mb_size=mb,
                                    num_microbatches=n_b, pool=pool,
                                    device=dev, n_stages=2))
        ref = _clone_caches(be.caches)
        act, entries = [None, None], [None, None]
        plan = [(0, False, True), (1, True, True), (0, False, True),
                (1, True, True), (0, False, False)]
        for t, (m, sampled, active) in enumerate(plan):
            toks, pos = inputs(t // 2)
            samp = _graph_samp(np, mb, t // 2, sampled)
            res = be.decode(m, toks, pos, samp, active=active)
            entries = [(m, pos, samp) if active else None] + entries[:-1]
            drained = entries[-1]
            dsamp = drained[2] if drained is not None else samp
            noise = gumbel_noise(dsamp, cfg.vocab_size, dev, gen)
            pos_stage = torch.from_numpy(np.stack(
                [e[1] if e is not None else np.zeros(mb, np.int32)
                 for e in entries])).to(dev)
            wt, wl, act = PL.pipeline_decode_tick(
                params, ref, act, torch.from_numpy(toks).to(dev), pos_stage,
                mb_assign=[e[0] if e is not None else -1 for e in entries],
                noise=noise, temp=torch.from_numpy(dsamp.temp).to(dev),
                top_k=torch.from_numpy(dsamp.top_k).to(dev),
                top_p=torch.from_numpy(dsamp.top_p).to(dev),
                sampled=dsamp.any_sampled, cfg=cfg, rt=rt, n_stages=2,
                mb_size=mb)
            if drained is None:
                n, gap = _cache_gap(torch, be.caches, ref)
                if gap > GRAPH_CACHE_ATOL:
                    raise AssertionError(f"graph-parity pipe tick {t}: "
                                         f"cache gap {gap}")
                log(f"[graph-parity] pipe tick {t} (stage 0 alone): cache "
                    f"leaves differing {n}, max gap {gap:.3e}")
                continue
            (r,) = res
            _graph_check(torch, f"pipe tick {t}, mb {drained[0]} drained "
                         f"{'sampled' if dsamp.any_sampled else 'greedy'}",
                         r.tokens, r.logprobs, wt, wl, be, ref, gaps)
        out["pipe"] = be.graphs.stats()
        del be, ref
        out.update(_prefill_graph_parity(torch, np, cfg, params, rt, dev,
                                         pool, table, fresh, gaps))
    out["ticks"] = gaps
    out["bit_equal"] = all(g["cache_leaves"] == 0 and g["logprob_gap"] == 0
                           for g in gaps)
    log(f"[graph-parity] on {card}: {len(gaps)} drained ticks and prefill "
        f"calls, every token equal; bit-equal {out['bit_equal']}; local "
        f"captures {out['local']['captures']} replays "
        f"{out['local']['replays']}; pipe captures "
        f"{out['pipe']['captures']} replays {out['pipe']['replays']}; "
        f"chunk captures {out['chunk']['captures']} replays "
        f"{out['chunk']['replays']}; pipe prefill captures "
        f"{out['pipe_prefill']['captures']} replays "
        f"{out['pipe_prefill']['replays']}")
    return out


def _prefill_check(torch, tag, got, want, be, ref, gaps):
    """Hold one replayed prefill call against the eager step: logits and
    cache writes equal (bit-equal expected; a gap within GRAPH_CACHE_ATOL
    is reported as cuBLAS rounding otherwise under capture, beyond it
    fails); the first tokens (the logits' argmax) equal."""
    gap = float((got.float() - want.float()).abs().max())
    n, cache_gap = _cache_gap(torch, be.caches, ref)
    if max(gap, cache_gap) > GRAPH_CACHE_ATOL or not torch.equal(
            got.argmax(-1), want.argmax(-1)):
        raise AssertionError(f"graph-parity {tag}: logits differ by {gap}, "
                             f"{n} cache leaves by up to {cache_gap}")
    gaps.append({"tick": tag, "logprob_gap": gap, "cache_leaves": n,
                 "cache_gap": cache_gap})
    note = "bit-equal" if n == 0 and gap == 0 else \
        "not bit-equal (cuBLAS rounds otherwise under capture)"
    log(f"[graph-parity] {tag}: first tokens equal; max |logit gap| "
        f"{gap:.3e}; cache leaves differing {n}, max gap {cache_gap:.3e}: "
        f"{note}")


def _graph_chunk(np, cfg, table, rng, rows: int, clen: int):
    """A prefill chunk of ``rows`` rows of ``clen`` tokens (the serve
    phase's shape) over the first rows' pages: random offsets, a row that
    ends inside the chunk, and a pad row."""
    from repro_torch.serving.backend import PrefillChunk
    n_valid = np.full((rows,), clen, np.int32)
    n_valid[1] = clen // 2
    n_valid[-1] = 0
    lasts = np.where(n_valid < clen, n_valid - 1, -1).astype(np.int32)
    lasts[-1] = -1
    offsets = (rng.randint(0, (GRAPH_CTX - clen) // clen, rows)
               * clen).astype(np.int32)
    offsets[-1] = 0
    return PrefillChunk(
        tokens=rng.randint(1, cfg.vocab_size, (rows, clen)).astype(np.int32),
        offsets=offsets, n_valid=n_valid, lasts=lasts,
        tables=table[:rows].astype(np.int32), seqs=[None] * rows)


def _prefill_graph_parity(torch, np, cfg, params, rt, dev, pool, table,
                          fresh, gaps) -> dict:
    """Phase 7g's prefill half: the local chunk step (8 rows x 32 tokens,
    the serve phase's chunk) and the pipe's prefill stages (2 x 24 layers)
    and drain, each a capturing call then replays with new inputs, held
    against ``_chunk_fn`` / ``pipeline_prefill_chunk_tick`` on a copy of
    the caches."""
    from repro_torch.core import pipeline as PL
    from repro_torch.serving.backend import LocalBackend, PipelinedBackend

    rows, clen = 2 * GRAPH_MB, 32
    rng = np.random.RandomState(SEED + 1)
    out = {}

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    be = fresh(LocalBackend(cfg, params, rt, mb_size=GRAPH_MB,
                            num_microbatches=2, pool=pool, device=dev))
    ref = _clone_caches(be.caches)
    for step in range(2):
        chunk = _graph_chunk(np, cfg, table, rng, rows, clen)
        want = LocalBackend._chunk_fn(
            params, ref, dev_t(chunk.tokens), dev_t(chunk.offsets),
            dev_t(chunk.n_valid), dev_t(chunk.lasts), dev_t(chunk.tables),
            cfg=cfg, rt=rt)
        (res,) = be.prefill_step(chunk)
        _prefill_check(torch, f"local chunk {rows}x{clen} call {step}",
                       res.logits, want, be, ref, gaps)
    out["chunk"] = be.graphs.stats()
    del be, ref

    be = fresh(PipelinedBackend(cfg, params, rt, mb_size=GRAPH_MB,
                                num_microbatches=2, pool=pool, device=dev,
                                n_stages=2))
    ref = _clone_caches(be.caches)
    entries, act = [None, None], [None, None]
    for t, chunk in enumerate([_graph_chunk(np, cfg, table, rng, rows, clen)
                               for _ in range(3)] + [None]):
        got = be.prefill_step(chunk)
        entries = [chunk] + entries[:-1]
        zero = np.zeros((rows,), np.int32)
        stage = lambda name: dev_t(np.stack(
            [getattr(e, name) if e is not None else
             (zero if name != "tables" else np.zeros_like(table[:rows]))
             for e in entries]))
        drained = entries[-1]
        logits, act = PL.pipeline_prefill_chunk_tick(
            params, ref, act,
            dev_t(entries[0].tokens if entries[0] is not None
                  else np.zeros((rows, clen), np.int32)),
            stage("offsets"), stage("n_valid"), stage("tables"),
            dev_t(drained.lasts if drained is not None else zero),
            occupied=[e is not None for e in entries], cfg=cfg, rt=rt,
            n_stages=2)
        if drained is None:
            continue
        (res,) = got
        _prefill_check(torch, f"pipe prefill tick {t} (stages "
                       f"{[e is not None for e in entries]}) drained",
                       res.logits, logits, be, ref, gaps)
    out["pipe_prefill"] = be.graphs.stats()
    del be, ref
    return out


def exact_graph_parity(torch, np, tag: str, cfg, params, rt, lengths,
                       max_pages: int, dev=None) -> dict:
    """An exact-prefill bucket of ``cfg`` (full width, the serve phase's
    weights) held against ``_prefill_fn``: three prompts of ``lengths``,
    one bucket, into slots 1, 3 and 0 of a 4-slot local backend; the
    first call runs eagerly, the second captures and replays, the third
    replays.  Each is also run eagerly on a copy of the caches; logits
    and cache writes must be equal (``_prefill_check``).  Logs each call's
    host ms and the capture's seconds.  ``dev`` rehearses it on the CPU
    (where the bucket runs eagerly every time)."""
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.backend import LocalBackend

    dev = dev or torch.device("cuda", 0)
    pool = kvc.PoolConfig(page_size=16, n_local_pages=4 * max_pages + 1,
                          max_pages_per_seq=max_pages)
    be = LocalBackend(cfg, params, rt, mb_size=2, num_microbatches=2,
                      pool=pool, device=dev)
    be.set_page_table(1 + np.arange(4 * max_pages, dtype=np.int32)
                      .reshape(4, max_pages))
    ref = _clone_caches(be.caches)
    rng = np.random.RandomState(SEED + 2)
    gaps, host_ms = [], []
    for slot, n in zip((1, 3, 0), lengths):
        bucket = max(8, 1 << (n - 1).bit_length()) \
            if cfg.recurrent_layer_count() else max(8, -(-n // 8) * 8)
        toks = np.zeros((bucket,), np.int32)
        toks[:n] = rng.randint(1, cfg.vocab_size, n)
        be.reset_slot(slot)
        kvc.reset_slot(ref, slot)
        with torch.inference_mode():
            want = LocalBackend._prefill_fn(
                params, ref, torch.from_numpy(toks[None]).to(dev), slot,
                n - 1, cfg=cfg, rt=rt, ranges=be.ranges,
                devices=be.stage_devices, head=be.head)
            t0 = time.perf_counter()
            got = be.prefill(toks, slot, n - 1)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        _prefill_check(torch, f"{tag} exact {n} tokens (bucket {bucket}) "
                       f"into slot {slot}", got, want, be, ref, gaps)
    st = be.graphs.stats()
    if st["captures"] != 1 or st["replays"] != 2 or \
            st["eager_by_kind"] != {"exact": 1}:
        raise AssertionError(f"graph-parity {tag}: the bucket ran "
                             f"{st['eager_by_kind']} eagerly, captured "
                             f"{st['captures']} and replayed "
                             f"{st['replays']} times, want 1 / 1 / 2")
    log(f"[graph-parity] {tag} exact bucket {bucket}: host ms a call "
        f"eager {host_ms[0]:.1f}, capture and replay {host_ms[1]:.1f} "
        f"(capture {st['capture_s'] * 1e3:.1f} ms, of which "
        f"instantiation {st['instantiate_s'] * 1e3:.1f}), replay "
        f"{host_ms[2]:.1f}")
    del be, ref
    return {"ticks": gaps, "host_ms": host_ms, "capture_s": st["capture_s"],
            "instantiate_s": st["instantiate_s"],
            "bit_equal": all(g["cache_leaves"] == 0 and g["logprob_gap"] == 0
                             for g in gaps)}


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
    EXACT_PARITY["gemma3-12b"] = exact_graph_parity(
        torch, np, "gemma3-12b", cfg, params, rt, GEMMA_PARITY_LENGTHS,
        GEMMA_MAX_PAGES)
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
    spans = time_replays(torch, llm.engine.backend)
    reset_counts()
    t1 = time.perf_counter()
    outs = llm.generate(prompts, sps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = read_counts()
    paged = counts["paged_attention"]
    flash = counts["flash_attention"]
    rep = llm.stats()
    graph_books(torch, "gemma3-12b", llm.engine.backend, rep, spans)
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
    return counts, outs, params


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
    EXACT_PARITY["recurrentgemma-9b"] = exact_graph_parity(
        torch, np, "recurrentgemma-9b", cfg, params, rt, RG_PARITY_LENGTHS,
        RG_MAX_PAGES)
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
    spans = time_replays(torch, llm.engine.backend)
    reset_counts()
    t1 = time.perf_counter()
    outs = llm.generate(prompts, sps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = read_counts()
    rep = llm.stats()
    graph_books(torch, "recurrentgemma-9b", llm.engine.backend, rep, spans)
    ticks = rep["decode_ticks"]
    bad = [o.request_id for o in outs
           if not o.finished or len(o.token_ids) != RG_NEW
           or not all(math.isfinite(x) for x in o.logprobs)
           or not all(0 <= t < cfg.vocab_size for t in o.token_ids)]
    if bad:
        raise AssertionError(f"recurrentgemma: requests {bad} unfinished, "
                             "short, or with non-finite log-probs")
    want = {"rglru_scan": RG_REQUESTS * n_rglru,
            "flash_attention": RG_REQUESTS * n_local, "paged_attention": 0,
            "chunk_attention": 0}
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
    spans = time_replays(torch, llm.engine.backend)
    reset_counts()
    t1 = time.perf_counter()
    outs = llm.generate(prompts, sps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = read_counts()
    rep = llm.stats()
    rep["generate_wall_s"] = wall
    rep["graphs"] = graph_books(torch, tag, llm.engine.backend, rep, spans)
    bad = [o.request_id for o in outs
           if not o.finished or len(o.token_ids) != SERVE_NEW
           or not all(math.isfinite(x) for x in o.logprobs)
           or not all(0 <= t < cfg.vocab_size for t in o.token_ids)]
    if bad:
        raise AssertionError(f"{tag}: requests {bad} unfinished, short, or "
                             "with non-finite log-probs")
    ticks = rep["decode_ticks"]
    # a pipelined tick runs only its occupied stages' layers: the pipeline
    # phase checks those launches itself
    if llm.engine.backend.name == "local" and (
            ticks == 0 or counts["paged_attention"] != ticks * YI_LAYERS):
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
    return ({tag: r["counts"] for tag, r in runs.items()}, info,
            runs["no-offload"])


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
        f"measured stage_time {t_s * 1e3:.2f} ms (the slowest of "
        f"{PLAN_STAGES} stages' single-sequence decode steps, each timed on "
        f"its device); latency "
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


def _watch_transport(backend):
    """Log every transport tick of ``backend``: (plane, occupied stages,
    raw payload bytes, per-stage compute seconds)."""
    ticks = []
    orig = backend.transport.tick

    def tick(occupied, nbytes, compute_s, inject_t=0.0, plane="decode"):
        ticks.append((plane, list(occupied), nbytes, list(compute_s)))
        return orig(occupied, nbytes, compute_s, inject_t, plane)
    backend.transport.tick = tick
    return ticks


def time_replays(torch, backend) -> list:
    """Record CUDA events around each replay of ``backend``'s captured
    steps (not around a key's first run, which warms up and captures, nor
    around a deferred key's eager first run); returns the list of (key
    kind, start, end) it fills."""
    graphs, spans = backend.graphs, []
    run = graphs.run

    def timed(key, device, step, state=None, defer=False):
        if not graphs.graphed(device) or key not in graphs.entries():
            return run(key, device, step, state, defer)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(device):
            start.record()
            run(key, device, step, state, defer)
            end.record()
        spans.append((key[0], start, end))
    graphs.run = timed
    return spans


def _prefill_calls(backend) -> dict:
    """The prefill calls a backend made, by the key kind that serves them:
    chunks (local), stage runs and drains (pipe), and exact prefills times
    their stages (a bucket's eager first call included)."""
    calls = {"exact": backend.exact_prefills * len(backend.stage_devices)}
    if backend.name == "local":
        calls["chunk"] = backend.prefill_chunks
    else:
        calls.update({"pf-stage": backend.prefill_stage_runs,
                      "pf-drain": backend.prefill_drains})
    return {k: v for k, v in calls.items() if v}


def graph_books(torch, tag: str, backend, rep: dict, spans=None) -> dict:
    """Check and log a served backend's captured steps: every key captured
    once, and (every stage on a card) the replays account for every call:
    decode ticks on the local backend, stage runs and drains on the
    pipelined one; prefill chunks, prefill stage runs and drains, and an
    exact prefill's stages (each bucket's eager first call aside).  Logs
    captures, replays, the host ms of a decode tick and of a prefill call
    (the engine's decode and prefill clocks over their calls) and, with
    ``spans`` from :func:`time_replays`, the replays' device ms a decode
    tick and a replay of each prefill kind."""
    from repro_torch.serving.step_graph import PREFILL_KINDS
    st = backend.graphs.stats()
    again = {k: n for k, n in backend.graphs.captures.items() if n != 1}
    if again:
        raise AssertionError(f"{tag}: keys captured more than once: {again}")
    kinds = st["replays_by_kind"]
    decode = {k: n for k, n in kinds.items() if k not in PREFILL_KINDS}
    prefill = {k: n + st["eager_by_kind"].get(k, 0)
               for k, n in kinds.items() if k in PREFILL_KINDS}
    prefill.update({k: n for k, n in st["eager_by_kind"].items()
                    if k not in prefill})
    if all(d.type == "cuda" for d in backend.stage_devices):
        want = {"local": backend.decode_ticks} if backend.name == "local" \
            else {"stage": backend.decode_stage_runs,
                  "drain": backend.epilogue_runs}
        want = {k: v for k, v in want.items() if v}
        if decode != want:
            raise AssertionError(f"{tag}: decode replays {decode} != the "
                                 f"ticks' {want}")
        if prefill != _prefill_calls(backend):
            raise AssertionError(f"{tag}: prefill replays and eager first "
                                 f"calls {prefill} != the calls' "
                                 f"{_prefill_calls(backend)}")
    ticks = max(1, rep["decode_ticks"])
    st["host_ms_a_tick"] = rep["decode_time_s"] / ticks * 1e3
    n_pf = backend.exact_prefills or getattr(backend, "prefill_chunks", 0) \
        or getattr(backend, "prefill_ticks", 0)
    st["prefill_calls"] = n_pf
    st["host_ms_a_prefill"] = rep["prefill_time_s"] / max(1, n_pf) * 1e3
    cap_s = {k: round(v, 3) for k, v in st["capture_s_by_kind"].items()}
    line = (f"[graphs] {tag}: {st['captures']} captures ({st['keys']} keys, "
            f"one each; decode {st['decode_captures']}, prefill "
            f"{st['prefill_captures']}) in {st['capture_s']:.2f} s "
            f"({st['instantiate_s']:.2f} s instantiating; by kind "
            f"{cap_s}), "
            f"{st['replays']} replays {kinds} on "
            f"{st['replays_by_device']} over {rep['decode_ticks']} decode "
            f"ticks and {n_pf} prefill calls (eager first calls "
            f"{st['eager_by_kind']}); host {st['host_ms_a_tick']:.2f} ms a "
            f"tick, {st['host_ms_a_prefill']:.2f} ms a prefill call")
    if spans:
        torch.cuda.synchronize()
        dec = [(a, b) for k, a, b in spans if k not in PREFILL_KINDS]
        dev_ms = sum(a.elapsed_time(b) for a, b in dec)
        # a key's first run (its capture) is not timed: spread the timed
        # replays' device time over the ticks they served
        timed_ticks = ticks * len(dec) / max(1, st["decode_replays"])
        st["device_ms_a_tick"] = dev_ms / max(1e-9, timed_ticks)
        st["timed_replays"] = len(dec)
        by_kind: dict = {}
        for k, a, b in spans:
            if k in PREFILL_KINDS:
                by_kind.setdefault(k, []).append(a.elapsed_time(b))
        st["prefill_device_ms_a_replay"] = {
            k: sum(v) / len(v) for k, v in by_kind.items()}
        line += (f"; device {st['device_ms_a_tick']:.2f} ms a tick in "
                 f"replays ({len(dec)} timed of {st['decode_replays']})")
        if by_kind:
            line += ", prefill " + ", ".join(
                f"{k} {sum(v) / len(v):.2f} ms a replay ({len(v)} timed)"
                for k, v in by_kind.items())
    pool = graph_pool_bytes(torch, backend)
    if pool is not None:
        st["pool_bytes"] = pool
        line += f"; graph pool {pool / 2 ** 30:.3f} GiB reserved"
    log(line)
    GRAPH_BOOKS[tag] = st
    return st


def graph_pool_bytes(torch, backend):
    """Bytes the card's allocator has reserved for ``backend``'s graph pool
    (the segments ``torch.cuda.memory_snapshot`` tags with its id), or
    None where the snapshot carries no pool ids."""
    pools = {tuple(p) for d, p in backend.graphs._pools.items()
             if d.type == "cuda"}
    if not pools:
        return 0
    total, tagged = 0, False
    for seg in torch.cuda.memory_snapshot():
        pid = seg.get("segment_pool_id")
        if pid is None:
            continue
        tagged = True
        if tuple(pid) in pools:
            total += seg["total_size"]
    return total if tagged else None


def info_tick(rep) -> float:
    """Ms of an engine's decode tick: its decode phase over its ticks."""
    return rep["decode_time_s"] / rep["decode_ticks"] * 1e3


def _decode_stage_time(ticks) -> float:
    """Mean per-stage compute seconds of the decode ticks with every stage
    occupied (the steady state the planner's T_S stands for)."""
    full = [c[0] for plane, occ, _, c in ticks
            if plane == "decode" and all(occ)]
    if not full:
        raise AssertionError("pipeline: no decode tick had every stage "
                             "occupied")
    return sum(full) / len(full)


def tick_split(torch, fn, iters: int) -> tuple:
    """Host ms and device ms of ``fn``, one decode tick ending in its
    device-to-host transfer, after 3 warm-up calls (which capture any key
    not captured yet): host, the median of synchronised calls on the host
    clock; device, the sum of the profiler's kernel rows a call
    (``launch.profile_decode.profile``; it sees the kernels of a graph's
    replay one by one)."""
    from repro_torch.launch.profile_decode import profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    _, _, rows = profile(torch, fn, iters)
    return sorted(host)[len(host) // 2] * 1e3, sum(r[0] for r in rows)


def _tick_split_local_vs_pipe(torch, np, cfg, rt, params, backend):
    """Host and device ms (:func:`tick_split`) of one decode tick of
    ``mb_size`` rows at a 700-token context on ``backend``'s full-width
    caches, eager and replayed: the local backend's step, and the
    pipelined tick with every stage occupied (one microbatch entering,
    one draining).  The eager ticks call the step functions as the eager
    backends did; the replayed ones go through the backends' ``decode``
    (a ``LocalBackend`` over the same caches, and ``backend`` itself),
    host inputs, replays and the one transfer included."""
    from repro_torch.core import pipeline as PL
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.backend import LocalBackend
    from repro_torch.serving.sampler import RowSampling
    dev = torch.device("cuda")
    mb, n_s = backend.mb_size, backend.n_stages
    per_row = backend.pool.max_pages_per_seq
    table = 1 + np.arange(backend.batch * per_row,
                          dtype=np.int32).reshape(backend.batch, per_row)
    kvc.set_page_table(backend.caches, table)
    tokens = torch.randint(1, cfg.vocab_size, (mb,), dtype=torch.int32,
                           device=dev)
    pos = torch.full((n_s, mb), PIPE_PROFILE_CTX, dtype=torch.int32,
                     device=dev)
    act = [None] + [torch.zeros((mb, 1, cfg.d_model), dtype=rt.compute_dtype,
                                device=dev) for _ in range(n_s - 1)]
    zeros = torch.zeros((mb,), device=dev)
    ints = torch.zeros((mb,), dtype=torch.int32, device=dev)
    host_toks = tokens.cpu().numpy()
    host_pos = np.full((mb,), PIPE_PROFILE_CTX, np.int32)
    greedy = RowSampling(keys=np.zeros(mb, np.int64),
                         steps=np.zeros(mb, np.int32),
                         temp=np.zeros(mb, np.float32),
                         top_k=np.zeros(mb, np.int32),
                         top_p=np.ones(mb, np.float32))
    local_be = LocalBackend(cfg, params, rt, mb_size=mb,
                            num_microbatches=backend.num_microbatches,
                            pool=backend.pool, device=dev,
                            caches=backend.caches)
    turn = [0]

    @torch.inference_mode()
    def local():
        toks, lps = LocalBackend._decode_fn(
            params, backend.caches, tokens, pos[0], 0, None, zeros, ints,
            zeros + 1, cfg=cfg, rt=rt, mb_size=mb, sampled=False)
        torch.stack([toks.float(), lps]).cpu()

    @torch.inference_mode()
    def piped():
        toks, lps, _ = PL.pipeline_decode_tick(
            params, backend.caches, act, tokens, pos,
            mb_assign=list(range(n_s - 1, -1, -1)), noise=None, temp=zeros,
            top_k=ints, top_p=zeros + 1, sampled=False, cfg=cfg, rt=rt,
            n_stages=n_s, mb_size=mb)
        torch.stack([toks.float(), lps]).cpu()

    @torch.inference_mode()
    def local_replay():
        local_be.decode(0, host_toks, host_pos, greedy)

    @torch.inference_mode()
    def piped_replay():
        # microbatches in turn, so that after the fill every stage holds
        # one and one drains
        turn[0] += 1
        backend.decode(turn[0] % backend.num_microbatches, host_toks,
                       host_pos, greedy)

    split = {name: tick_split(torch, fn, PIPE_PROFILE_TICKS)
             for name, fn in (("local", local), ("local replayed",
                                                 local_replay),
                              ("pipelined", piped),
                              ("pipelined replayed", piped_replay))}
    with torch.inference_mode():
        while backend.pending():
            backend.decode(0, host_toks, host_pos, greedy, active=False)
    return split


def phase_pipeline(torch, np, card: str, params, local_run):
    """§4.3's circular pipeline at full width and depth on yi-9b (bf16, the
    weights of the serve phases):

    1. N_S = 2, N_B = 4, mb_size 4, fp32 wire, in-process links, the local
       no-offload engine's pool: every stream equals that engine's
       (``local_outs``), and the paged kernel runs (stage layers) times a
       stage run;
    2. the same with the offloaded pools, one offloader a stage: streams
       equal run 1's, swap books a stage;
    3. N_S = 4, int8 wire, 64 ms simulated links: every request at full
       length with finite log-probs, the transport's wire bytes those of
       the packed payloads that crossed;
    4. the latency curve: circular at the planner's N_B for run 1's stage
       time against round_flush at N_B = N_S, 64 ms links, measured stage
       times: equal streams, circular at least 3x the virtual decode
       tok/s.
    """
    import gc

    from repro_torch.config import get_arch
    from repro_torch.core import pipeline as PL
    from repro_torch.core.scheduler import optimal_microbatches
    from repro_torch.core.simulator import PipelineSimulator, SimConfig
    from repro_torch.distributed.compression import int8_wire_bytes
    from repro_torch.distributed.transport import SimulatedLinkTransport
    from repro_torch.models.common import Runtime
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import LLM, EngineConfig
    from repro_torch.serving.request import SamplingParams

    cfg = get_arch("yi-9b")
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    info, counts, walls = {}, {}, {}

    def engine(n_local, n_global, **kw):
        gc.collect()
        torch.cuda.empty_cache()
        base = dict(mb_size=PIPE_MB, num_microbatches=PIPE_N_MB,
                    pool=PoolConfig(page_size=SERVE_PAGE,
                                    n_local_pages=n_local,
                                    n_global_pages=n_global,
                                    max_pages_per_seq=SERVE_MAX_PAGES),
                    seed=SEED, max_prefill_tokens_per_tick=256,
                    backend="pipelined", n_stages=PIPE_STAGES)
        base.update(kw)
        return LLM(cfg, config=EngineConfig(**base), params=params, rt=rt,
                   reduced=False, device="cuda")

    def check_launches(tag, llm, c):
        be = llm.engine.backend
        per_stage = YI_LAYERS // be.n_stages
        epi = be.ranges[-1][1] - be.ranges[-1][0]
        want = be.decode_stage_runs * per_stage + be.epilogue_runs * epi
        if c["paged_attention"] != want or want == 0:
            raise AssertionError(
                f"{tag}: {c['paged_attention']} paged launches, want "
                f"{be.decode_stage_runs} stage runs x {per_stage} layers + "
                f"{be.epilogue_runs} drains x {epi}")
        log(f"[{tag}] paged launches {c['paged_attention']} = "
            f"{be.decode_stage_runs} stage runs x {per_stage} layers over "
            f"{be.decode_ticks} decode ticks")

    # -- run 1: two stages, fp32, in process --------------------------------
    t0 = time.perf_counter()
    local_outs, local_rep = local_run["outs"], local_run["rep"]
    local_tick = info_tick(local_rep)
    llm = engine(OFF_BASE_LOCAL, 0)
    ticks = _watch_transport(llm.engine.backend)
    outs1, rep1, counts["yi-9b pipelined"] = _serve_yi(
        torch, np, llm, "pipe", card)
    check_launches("pipe", llm, counts["yi-9b pipelined"])
    diff = [o.request_id for o, p in zip(outs1, local_outs)
            if o.token_ids != p.token_ids]
    if diff:
        raise AssertionError(f"pipe: streams of requests {diff} differ from "
                             "the local engine's")
    lp = max(abs(x - y) for o, p in zip(outs1, local_outs)
             for x, y in zip(o.logprobs, p.logprobs))
    t_s = _decode_stage_time(ticks)
    split = _tick_split_local_vs_pipe(torch, np, cfg, rt, params,
                                      llm.engine.backend)
    log(f"[pipe] all {len(outs1)} streams (greedy and sampled) equal the "
        f"local engine's (N_B {PIPE_N_MB}, mb_size {PIPE_MB}, "
        f"{OFF_BASE_LOCAL} local pages) token for token; max |log-prob "
        f"difference| {lp:.3e}; stage time T_S {t_s * 1e3:.2f} ms (a full "
        f"decode tick / {PIPE_STAGES}, mean over the ticks with every "
        "stage occupied)")
    log(f"[pipe] decode {rep1['decode_tok_per_s']:.1f} tok/s, prefill "
        f"{rep1['prefill_tok_per_s']:.1f} tok/s, {info_tick(rep1):.2f} ms a "
        f"decode tick over {rep1['decode_ticks']} ticks; the local engine: "
        f"decode {local_rep['decode_tok_per_s']:.1f}, prefill "
        f"{local_rep['prefill_tok_per_s']:.1f} tok/s, {local_tick:.2f} ms "
        f"a tick over {local_rep['decode_ticks']} ticks")
    log(f"[pipe] one decode tick of {PIPE_MB} rows at {PIPE_PROFILE_CTX} "
        f"tokens on {card}: " + "; ".join(
            f"{k} host {h:.2f} ms, device {d:.2f} ms"
            for k, (h, d) in split.items()))
    info["run1"] = {"decode_tok_per_s": rep1["decode_tok_per_s"],
                    "prefill_tok_per_s": rep1["prefill_tok_per_s"],
                    "tick_ms": info_tick(rep1),
                    "decode_ticks": rep1["decode_ticks"],
                    "stage_time_ms": t_s * 1e3,
                    "tick_host_device_ms": split,
                    "local": {"decode_tok_per_s":
                              local_rep["decode_tok_per_s"],
                              "prefill_tok_per_s":
                              local_rep["prefill_tok_per_s"],
                              "tick_ms": local_tick,
                              "decode_ticks": local_rep["decode_ticks"]}}
    del llm
    walls["run1"] = time.perf_counter() - t0

    # -- run 2: the same with one offloader a stage ---------------------------
    t0 = time.perf_counter()
    llm = engine(OFF_LOCAL, OFF_GLOBAL)
    outs2, rep2, counts["yi-9b pipelined offload"] = _serve_yi(
        torch, np, llm, "pipe-offload", card)
    check_launches("pipe-offload", llm, counts["yi-9b pipelined offload"])
    diff = [o.request_id for o, p in zip(outs2, outs1)
            if o.token_ids != p.token_ids]
    if diff:
        raise AssertionError(f"pipe-offload: streams of requests {diff} "
                             "differ from run 1's")
    be = llm.engine.backend
    if len(be.stage_offloaders) != PIPE_STAGES or be.swap_count < 2:
        raise AssertionError(f"pipe-offload: {len(be.stage_offloaders)} "
                             f"stage offloaders, {be.swap_count} swaps")
    info["run2"] = {"decode_tok_per_s": rep2["decode_tok_per_s"],
                    "prefill_tok_per_s": rep2["prefill_tok_per_s"],
                    "tick_ms": info_tick(rep2),
                    "decode_ticks": rep2["decode_ticks"],
                    "prefill_ticks": be.prefill_ticks,
                    "wall_s": rep2["generate_wall_s"], "stages": [
                        _offload_line(f"pipe-offload stage {s}", off,
                                      rep2["decode_ticks"], card)
                        for s, off in enumerate(be.stage_offloaders)]}
    log(f"[pipe-offload] all {len(outs2)} streams equal run 1's token for "
        f"token; {be.swap_count} swaps over {len(be.stage_offloaders)} "
        "stage offloaders")
    del llm, be
    walls["run2"] = time.perf_counter() - t0

    # -- run 3: four stages, int8 wire, 64 ms links -------------------------
    t0 = time.perf_counter()
    packed = [0, 0]                     # bytes, crossings

    def compress(x, _orig=PL.int8_compress_rows):
        q, scale = _orig(x)
        packed[0] += int8_wire_bytes(q.numel(), scale.numel())
        packed[1] += 1
        return q, scale
    PL.int8_compress_rows = compress
    try:
        llm = engine(OFF_BASE_LOCAL, 0, n_stages=PIPE_INT8_STAGES,
                     num_microbatches=PIPE_INT8_STAGES, wire_dtype="int8",
                     transport=SimulatedLinkTransport.uniform(
                         PIPE_INT8_STAGES, PIPE_LINK))
        # each admission's width and the stages flagged then: the simulated
        # links' stalls are part of each stage's observed seconds
        eng, admissions = llm.engine, []

        def rows(_orig=eng._tick_prefill_rows):
            w = _orig()
            admissions.append((w, tuple(eng.straggler.stragglers())))
            return w
        eng._tick_prefill_rows = rows
        outs3, rep3, counts["yi-9b pipelined int8"] = _serve_yi(
            torch, np, llm, "pipe-int8", card)
    finally:
        PL.int8_compress_rows = compress.__defaults__[0]
    flagged = [(w, st) for w, st in admissions if st]
    check_launches("pipe-int8", llm, counts["yi-9b pipelined int8"])
    tr = rep3["transport"]
    returns = tr["link_sends"] - packed[1]
    want = packed[0] + returns * llm.engine.backend.transport.inner.return_bytes
    if tr["wire_bytes"] != want:
        raise AssertionError(f"pipe-int8: the transport booked "
                             f"{tr['wire_bytes']} wire bytes, the packed "
                             f"payloads and returns were {want}")
    greedy = [(o.token_ids, p.token_ids) for i, (o, p) in
              enumerate(zip(outs3, outs1)) if i % 2 == 0]
    same = sum(a == b for x, y in greedy for a, b in zip(x, y))
    share = same / sum(len(x) for x, _ in greedy)
    log(f"[pipe-int8] {PIPE_INT8_STAGES} stages, int8 wire, "
        f"{PIPE_LINK * 1e3:.0f} ms links: {tr['wire_bytes']} wire bytes = "
        f"{packed[1]} packed crossings ({packed[0]} B) + {returns} returns; "
        f"{tr.get('compression_ratio', 0):.3f}x under the raw payload; "
        f"{share:.1%} of the greedy tokens equal run 1's (not gated); "
        f"virtual decode tok/s {rep3['virtual_decode_tok_per_s']:.1f}; "
        f"{len(flagged)} of {len(admissions)} admissions with a stage "
        f"flagged (stages {sorted({s for _, st in flagged for s in st})}, "
        f"rows down to {min((w for w, _ in flagged), default=None)} of "
        f"{eng.prefill_rows})")
    info["run3"] = {"decode_tok_per_s": rep3["decode_tok_per_s"],
                    "transport": tr, "greedy_share_equal": share,
                    "admissions": len(admissions),
                    "admissions_flagged": len(flagged),
                    "decode_stage_runs": eng.backend.decode_stage_runs,
                    "virtual_decode_tok_per_s":
                        rep3["virtual_decode_tok_per_s"]}
    del llm, eng
    walls["run3"] = time.perf_counter() - t0

    # -- run 4: the latency curve at 64 ms ------------------------------------
    t0 = time.perf_counter()
    n_b_star = min(CURVE_MAX_NB, optimal_microbatches(PIPE_STAGES, t_s,
                                                      PIPE_LINK))
    curve, streams = {}, {}
    rng = np.random.RandomState(SEED + 2)
    lens = rng.randint(CURVE_PROMPTS[0], CURVE_PROMPTS[1] + 1,
                       n_b_star * PIPE_MB)
    curve_prompts = [list(rng.randint(1, cfg.vocab_size, n)) for n in lens]
    for schedule, n_b in (("circular", n_b_star),
                          ("round_flush", PIPE_STAGES)):
        n_req = n_b * PIPE_MB
        prompts = curve_prompts[:n_req]
        llm = engine(n_req * CURVE_PAGES + 1, 0, num_microbatches=n_b,
                     schedule=schedule, pool=PoolConfig(
                         page_size=SERVE_PAGE,
                         n_local_pages=n_req * CURVE_PAGES + 1,
                         max_pages_per_seq=CURVE_PAGES),
                     transport=SimulatedLinkTransport.uniform(PIPE_STAGES,
                                                              PIPE_LINK))
        ticks = _watch_transport(llm.engine.backend)
        spans = time_replays(torch, llm.engine.backend)
        reset_counts()
        outs = llm.generate(prompts, SamplingParams(
            temperature=0.0, max_new_tokens=CURVE_NEW, logprobs=True))
        torch.cuda.synchronize()
        rep = llm.stats()
        books = graph_books(torch, f"curve-{schedule}", llm.engine.backend,
                            rep, spans)
        if not all(o.finished and len(o.token_ids) == CURVE_NEW
                   and all(math.isfinite(x) for x in o.logprobs)
                   for o in outs):
            raise AssertionError(f"curve {schedule}: unfinished requests")
        counts[f"yi-9b curve {schedule}"] = read_counts()
        check_launches(f"curve-{schedule}", llm,
                       counts[f"yi-9b curve {schedule}"])
        streams[schedule] = [o.token_ids for o in outs]
        ts = _decode_stage_time(ticks)
        sim = PipelineSimulator(SimConfig(
            policy="vllm_pp" if schedule == "round_flush" else "deserve_pp",
            n_stages=PIPE_STAGES, latency=PIPE_LINK))
        sim_tps = n_b * PIPE_MB / sim._round_time(ts, n_b)
        vtps = rep["virtual_decode_tok_per_s"]
        curve[schedule] = {"n_b": n_b, "requests": n_req,
                           "virtual_decode_tok_per_s": vtps,
                           "sim_tok_per_s": sim_tps,
                           "stage_time_ms": ts * 1e3,
                           "decode_ticks": rep["decode_ticks"],
                           "virtual_time_s":
                               rep["transport"]["virtual_time_s"],
                           "link_stall_s": rep["transport"]["link_stall_s"],
                           "decode_tok_per_s": rep["decode_tok_per_s"],
                           "host_ms_a_tick": books["host_ms_a_tick"],
                           "device_ms_a_tick":
                               books.get("device_ms_a_tick")}
        log(f"[curve] {schedule:11s} N_B {n_b:2d} x {PIPE_MB} rows, "
            f"{n_req} requests of {CURVE_PROMPTS[0]}-{CURVE_PROMPTS[1]} + "
            f"{CURVE_NEW} tokens, {PIPE_LINK * 1e3:.0f} ms links: "
            f"{vtps:.1f} virtual decode tok/s (the simulator's round time "
            f"predicts {sim_tps:.1f} at the measured T_S {ts * 1e3:.2f} ms: "
            f"measured / predicted {vtps / sim_tps:.3f}); "
            f"{rep['decode_ticks']} decode ticks, wall decode "
            f"{rep['decode_tok_per_s']:.1f} tok/s")
        del llm
    # the round_flush run serves the first N_S x mb_size of the requests
    if streams["circular"][:len(streams["round_flush"])] != \
            streams["round_flush"]:
        raise AssertionError("curve: round_flush streams differ from "
                             "circular's")
    ratio = curve["circular"]["virtual_decode_tok_per_s"] / \
        curve["round_flush"]["virtual_decode_tok_per_s"]
    sim_ratio = curve["circular"]["sim_tok_per_s"] / \
        curve["round_flush"]["sim_tok_per_s"]
    log(f"[curve] circular / round_flush at {PIPE_LINK * 1e3:.0f} ms on "
        f"{card}: {ratio:.2f}x (floor {CURVE_FLOOR}x, the JAX latency "
        f"curve's); measured T_S circular "
        f"{curve['circular']['stage_time_ms']:.3f} ms, round_flush "
        f"{curve['round_flush']['stage_time_ms']:.3f} ms (run 1's "
        f"{t_s * 1e3:.3f} ms set N_B {n_b_star}); the simulator at each "
        f"measured T_S predicts {curve['circular']['sim_tok_per_s']:.1f} / "
        f"{curve['round_flush']['sim_tok_per_s']:.1f} virtual tok/s, a "
        f"ratio of {sim_ratio:.2f}x")
    if ratio < CURVE_FLOOR:
        raise AssertionError(f"curve: circular is {ratio:.2f}x round_flush, "
                             f"under the {CURVE_FLOOR}x floor")
    curve["ratio"] = ratio
    info["curve"] = curve
    walls["run4"] = time.perf_counter() - t0
    info["wall_s"] = walls
    log(f"[pipe] phase wall times: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items()))
    return counts, info, outs3, outs1


# ---------------------------------------------------------------------------
# phase 11: resilience and online serving
# ---------------------------------------------------------------------------


def _yi_requests(np, vocab: int, n: int, prompts_range, new: int,
                 head=()):
    """The yi-9b phase's requests (the same seed), each behind ``head``:
    even ones greedy, odd ones sampled, with log-probs."""
    from repro_torch.serving.request import SamplingParams
    rng = np.random.RandomState(SEED)
    lens = rng.randint(prompts_range[0], prompts_range[1] + 1, n)
    prompts = [list(head) + [int(t) for t in rng.randint(1, vocab, k)]
               for k in lens]
    sps = [SamplingParams(temperature=0.0, max_new_tokens=new,
                          logprobs=True) if i % 2 == 0 else
           SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                          max_new_tokens=new, logprobs=True)
           for i in range(n)]
    return prompts, sps


def _check_outs(tag, outs, new: int, vocab: int, ref=None):
    """Every request at full length with finite log-probs; with ``ref``,
    every stream equal to its token for token."""
    bad = [o.request_id for o in outs
           if not o.finished or len(o.token_ids) != new
           or not all(math.isfinite(x) for x in o.logprobs)
           or not all(0 <= t < vocab for t in o.token_ids)]
    if bad:
        raise AssertionError(f"{tag}: requests {bad} unfinished, short, or "
                             "with non-finite log-probs")
    if ref is not None:
        diff = [o.request_id for o, r in zip(outs, ref)
                if o.token_ids != r.token_ids]
        if diff:
            raise AssertionError(f"{tag}: streams of requests {diff} differ "
                                 "from the reference's")


class _StageRuns:
    """Paged launches a pipelined run must make: each backend's decode
    stage runs times its layers a stage, plus its drains times the
    epilogue's layers, summed over the backends a reshard replaced."""

    def __init__(self):
        self.want = 0
        self.parts = []

    def add(self, be) -> None:
        per = be.ranges[0][1] - be.ranges[0][0]
        epi = be.ranges[-1][1] - be.ranges[-1][0]
        self.want += be.decode_stage_runs * per + be.epilogue_runs * epi
        self.parts.append(f"{be.decode_stage_runs} stage runs x {per}"
                          + (f" + {be.epilogue_runs} x {epi}" if epi else ""))

    def check(self, tag: str, launches: int) -> str:
        if launches != self.want or self.want == 0:
            raise AssertionError(f"{tag}: {launches} paged launches, want "
                                 f"{' + '.join(self.parts)} = {self.want}")
        return " + ".join(self.parts)


def phase_parity_resilience(torch, np, devices=("cpu", "cuda")):
    """Phase 6's yi-shaped 2-layer model, float32, on the CPU (plain path)
    and on the card (kernels): a fault storm through the 2-stage pipe with
    its offloaded pools, a reshard 2 -> 1 mid-run, and a prefix-cached
    online run over the local backend; each run's greedy streams equal
    across the two devices and equal the undisturbed run's."""
    import dataclasses

    from repro_torch.config import get_arch
    from repro_torch.distributed.elastic import FaultPlan
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import Runtime
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import LLM, EngineConfig, RequestOutput
    from repro_torch.serving.online import OnlineLLM
    from repro_torch.serving.request import SamplingParams

    rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
    cfg = dataclasses.replace(get_arch("yi-9b"), name="yi-9b-2layer",
                              num_layers=2, d_model=512, d_ff=1024,
                              vocab_size=2048)
    cpu_params = model_lib.init_params(cfg, SEED, rt, "cpu")
    rng = np.random.RandomState(SEED + 1)
    head = [int(t) for t in rng.randint(1, cfg.vocab_size, 64)]
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size, n)]
               for n in rng.randint(20, 200, 10)]
    sp = SamplingParams(temperature=0.0, max_new_tokens=16)
    pipe = dict(backend="pipelined", n_stages=2, mb_size=4,
                num_microbatches=4, pool=PoolConfig(
                    page_size=16, n_local_pages=32, n_global_pages=64,
                    max_pages_per_seq=16))
    storm = ["drop@decode:10:0", "drop@decode:21:1", "drop@prefill:2:0",
             "drop@prefill:5:1", "delay@decode:6:1:0.05"]
    runs = {}
    for dev in devices:
        params = {"embed": {k: v.to(dev) for k, v in
                            cpu_params["embed"].items()},
                  "final_norm": cpu_params["final_norm"].to(dev),
                  "layers": [{k: v.to(dev) for k, v in w.items()}
                             for w in cpu_params["layers"]]}

        def make(**kw):
            conf = dict(pipe)
            conf.update(kw)
            return LLM(cfg, config=EngineConfig(**conf), params=params,
                       rt=rt, device=dev)
        out = {"plain": [o.token_ids for o in make().generate(prompts, sp)]}
        plan = FaultPlan.parse(storm)
        llm = make(fault_plan=plan)
        out["storm"] = [o.token_ids for o in llm.generate(prompts, sp)]
        out["lost"] = (llm.engine.stats.decode_ticks_lost,
                       llm.engine.stats.prefill_chunks_lost, plan.pending())
        llm = make()
        seqs = llm.engine.submit(llm._make_requests(prompts, sp))
        step = 0
        while llm.engine.step():
            step += 1
            if step == 30:
                llm.engine.reshard(n_stages=1)
        out["reshard"] = [RequestOutput.from_seq(s).token_ids for s in seqs]
        heads = [head + p for p in prompts]
        llm = make(backend="local", n_stages=2, prefix_cache=True,
                   pool=PoolConfig(page_size=16, n_local_pages=129,
                                   max_pages_per_seq=24))
        online = OnlineLLM(llm=llm)
        streams = [online.submit(p, sp) for p in heads]
        out["online"] = [s.result().token_ids for s in streams]
        out["hits"] = llm.engine.stats.prefix_hits
        out["online_plain"] = [o.token_ids for o in make(
            backend="local", n_stages=2, pool=PoolConfig(
                page_size=16, n_local_pages=129,
                max_pages_per_seq=24)).generate(heads, sp)]
        runs[len(runs)] = out
        log(f"[parity] resilience on {dev}: fault storm lost "
            f"{out['lost'][0]} decode ticks and {out['lost'][1]} prefill "
            f"chunks ({out['lost'][2]} events pending); reshard 2 -> 1 at "
            f"step 30; online with a 64-token shared head, {out['hits']} "
            "prefix hits")
    cpu, card = runs[0], runs[1]
    for key in ("plain", "storm", "reshard", "online", "online_plain",
                "lost", "hits"):
        if cpu[key] != card[key]:
            raise AssertionError(f"parity resilience: {key} differs CPU vs "
                                 f"card")
    for run in runs.values():
        if run["storm"] != run["plain"] or run["reshard"] != run["plain"] \
                or run["online"] != run["online_plain"]:
            raise AssertionError("parity resilience: a disturbed run's "
                                 "streams differ from the undisturbed run's")
    if cpu["lost"] != (2, 2, 0) or cpu["hits"] == 0:
        raise AssertionError(f"parity resilience: lost {cpu['lost']}, "
                             f"{cpu['hits']} prefix hits")
    log("[parity] resilience: greedy streams identical, plain path (CPU) vs "
        "kernel path (card), each equal to its undisturbed run")


def phase_resilience(torch, np, card: str, params, local_run, serve_wall,
                     pipe_run2):
    """Phase 11 at full width and depth on yi-9b (bf16, the serve phases'
    weights and 20 requests; the reference streams are the local
    no-offload engine's, ``local_run``):

    1. fault storm: 2 stages, N_B 4, mb_size 4, the offloaded pools with
       an offloader a stage; a fixed plan drops a decode tick at stage 0
       and at stage 1, the final drain, and two prefill ticks, and delays
       stage 1 on 8 consecutive decode ticks.  Streams equal the
       reference, the lost counts equal the drops, the plan is spent;
    2. reshard 2 -> 4 -> 1 mid-run, offloaded: streams equal, no token
       generated twice;
    3. detector drill: 4 stages, stage 1 delayed (the mitigator flags it
       and the admission narrows), device 3 silenced, reshard to the
       planner's target for 3 live devices;
    4. online, local backend, a 512-token shared system prompt, Poisson
       arrivals at 0.5x and 1.5x the yi-9b phase's offline request rate,
       the prefix cache on: streams equal an offline run without it;
    5. the threaded pump with SLO admission.

    TTFT is taken from each request's scheduled Poisson arrival to its
    first token's delivery, so a submission that waits for a running step
    counts that wait."""
    import gc

    from repro_torch.config import get_arch
    from repro_torch.distributed.elastic import FailureDetector, FaultPlan
    from repro_torch.models.common import Runtime
    from repro_torch.serving.engine import SLOConfig
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import LLM, EngineConfig, RequestOutput
    from repro_torch.serving.online import OnlineLLM

    cfg = get_arch("yi-9b")
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    vocab, n_req, new = cfg.vocab_size, SERVE_REQUESTS, SERVE_NEW
    ref = local_run["outs"]
    prompts, sps = _yi_requests(np, vocab, n_req, SERVE_PROMPTS, new)
    info, counts = {}, {}

    def engine(**kw):
        gc.collect()
        torch.cuda.empty_cache()
        base = dict(mb_size=PIPE_MB, num_microbatches=PIPE_N_MB,
                    pool=PoolConfig(page_size=SERVE_PAGE,
                                    n_local_pages=OFF_LOCAL,
                                    n_global_pages=OFF_GLOBAL,
                                    max_pages_per_seq=SERVE_MAX_PAGES),
                    seed=SEED, max_prefill_tokens_per_tick=256,
                    backend="pipelined", n_stages=RES_STAGES)
        base.update(kw)
        return LLM(cfg, config=EngineConfig(**base), params=params, rt=rt,
                   reduced=False, device="cuda")

    def drive(llm, hook):
        """Submit the requests, step until drained calling ``hook(step)``
        after each step; the outputs and the generate wall seconds."""
        eng = llm.engine
        seqs = eng.submit(llm._make_requests(prompts, sps))
        reset_counts()
        t0 = time.perf_counter()
        step = 0
        while eng.step():
            step += 1
            hook(step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return [RequestOutput.from_seq(s) for s in seqs], wall

    # -- run 1: the fault storm ---------------------------------------------
    delays = [f"delay@decode:{t}:1:{RES_DELAY_S}"
              for t in range(RES_DELAY_FROM,
                             RES_DELAY_FROM + RES_DELAY_TICKS)]
    plan = FaultPlan.parse(list(RES_DROPS) + delays)
    llm = engine(fault_plan=plan)
    eng = llm.engine
    ratio = [0.0]

    def storm_hook(step):
        st = eng.straggler
        if st.ewma[0] > 0:
            ratio[0] = max(ratio[0], st.ewma[1] / st.ewma[0])
    outs, wall = drive(llm, storm_hook)
    c = counts["yi-9b fault storm"] = read_counts()
    rep = llm.stats()
    be = eng.backend
    graph_books(torch, "res-storm", be, rep)
    runs = _StageRuns()
    runs.add(be)
    split = runs.check("storm", c["paged_attention"])
    _check_outs("storm", outs, new, vocab, ref)
    lost = (rep["decode_ticks_lost"], rep["prefill_chunks_lost"])
    if lost != (3, 2) or plan.pending():
        raise AssertionError(f"storm: lost {lost}, want (3, 2); "
                             f"{plan.pending()} events pending")
    extra = (rep["decode_ticks"] - pipe_run2["decode_ticks"],
             be.prefill_ticks - pipe_run2["prefill_ticks"])
    stages = rep["stages"]
    info["storm"] = dict(
        decode_ticks_lost=lost[0], prefill_chunks_lost=lost[1],
        drops=list(RES_DROPS), decode_ticks=rep["decode_ticks"],
        prefill_ticks=be.prefill_ticks, extra_ticks=extra, wall_s=wall,
        undisturbed_wall_s=pipe_run2["wall_s"],
        ewma_ratio_max=ratio[0], stragglers=stages["stragglers"],
        paged_launches=c["paged_attention"])
    log(f"[res-storm] 2 stages, N_B {PIPE_N_MB} x {PIPE_MB}, offloaded "
        f"pools: drops {', '.join(RES_DROPS)}; stage 1 delayed {RES_DELAY_S * 1e3:.0f} ms "
        f"on decode ticks {RES_DELAY_FROM}-"
        f"{RES_DELAY_FROM + RES_DELAY_TICKS - 1}; all {len(outs)} streams "
        f"equal the local engine's; lost {lost[0]} decode ticks and "
        f"{lost[1]} prefill chunks, plan spent")
    log(f"[res-storm] on {card}: {rep['decode_ticks']} decode + "
        f"{be.prefill_ticks} prefill ticks against the undisturbed "
        f"pipeline run's {pipe_run2['decode_ticks']} + "
        f"{pipe_run2['prefill_ticks']} ({extra[0]:+d} / {extra[1]:+d}); "
        f"wall {wall:.3f} s against {pipe_run2['wall_s']:.3f} s; stage 1's "
        f"EWMA peaked at {ratio[0]:.2f}x stage 0's (two stages: the upper "
        f"median is the slower stage, so none is flagged: "
        f"{stages['stragglers']}); paged launches {c['paged_attention']} "
        f"= {split}")
    del llm, eng, be

    # -- run 2: reshard 2 -> 4 -> 1 -------------------------------------------
    llm = engine()
    eng = llm.engine
    runs = _StageRuns()
    resh = []

    def reshard_hook(step):
        if step not in RES_RESHARD_STEPS:
            return
        if eng.backend.swap_count == 0:
            raise AssertionError("reshard: the offloaders never swapped")
        old = eng.backend
        kw = dict(n_stages=4) if step == RES_RESHARD_STEPS[0] \
            else dict(live_devices=1)
        r = eng.reshard(**kw)
        graph_books(torch, f"res-reshard, the {old.n_stages}-stage pipe",
                    old, llm.stats())
        runs.add(old)
        resh.append(dict(step=step, stages=(old.n_stages,
                                            eng.backend.n_stages),
                         seconds=r["seconds"],
                         gib=r["bytes_migrated"] / 2 ** 30))
    outs, wall = drive(llm, reshard_hook)
    c = counts["yi-9b reshard"] = read_counts()
    runs.add(eng.backend)
    split = runs.check("reshard", c["paged_attention"])
    _check_outs("reshard", outs, new, vocab, ref)
    rep = llm.stats()
    graph_books(torch, "res-reshard, the last pipe", eng.backend, rep)
    want_tokens = sum(len(o.token_ids) for o in ref)
    if rep["reshards"] != 2 or rep["decode_tokens"] != want_tokens:
        raise AssertionError(f"reshard: {rep['reshards']} reshards, "
                             f"{rep['decode_tokens']} tokens generated, "
                             f"want 2 and {want_tokens}")
    info["reshard"] = dict(reshards=resh, wall_s=wall,
                           decode_tokens=rep["decode_tokens"],
                           paged_launches=c["paged_attention"])
    for r in resh:
        s = r["seconds"]
        log(f"[res-reshard] step {r['step']}: {r['stages'][0]} -> "
            f"{r['stages'][1]} stages on {card}: drain "
            f"{s['drain'] * 1e3:.1f} ms, export {s['export'] * 1e3:.1f} ms, "
            f"rebuild {s['rebuild'] * 1e3:.1f} ms, import "
            f"{s['import'] * 1e3:.1f} ms; {r['gib']:.3f} GiB of host "
            "stores migrated")
    log(f"[res-reshard] all {len(outs)} streams equal the local engine's; "
        f"{rep['decode_tokens']} tokens generated (the reference's "
        f"{want_tokens}: none twice); wall {wall:.3f} s; paged launches "
        f"{c['paged_attention']} = {split}")
    del llm, eng

    # -- run 3: the detector drill, 4 stages ----------------------------------
    plan = FaultPlan.parse(delays)
    llm = engine(n_stages=4, fault_plan=plan)
    eng = llm.engine
    runs = _StageRuns()
    fd = FailureDetector(timeout=RES_TIMEOUT)
    for dev in range(4):
        fd.beat(dev, 0.0)
    widths, drill = [], {}
    orig_rows = eng._tick_prefill_rows

    def rows():
        w = orig_rows()
        if eng.straggler is not None and eng.backend.n_stages == 4:
            widths.append((w, tuple(eng.straggler.stragglers())))
        return w
    eng._tick_prefill_rows = rows

    def drill_hook(step):
        for dev in range(4):
            if dev != 3 or step <= RES_KILL_STEP:
                fd.beat(dev, float(step))
        if fd.dead(float(step)) and not drill:
            old = eng.backend
            r = eng.reshard(detector=fd, now=float(step))
            runs.add(old)
            drill.update(step=step, dead=fd.dead(float(step)),
                         stages=(old.n_stages, eng.backend.n_stages),
                         seconds=r["seconds"],
                         gib=r["bytes_migrated"] / 2 ** 30)
    outs, wall = drive(llm, drill_hook)
    c = counts["yi-9b detector drill"] = read_counts()
    graph_books(torch, "res-drill, the pipe after the reshard",
                eng.backend, llm.stats())
    runs.add(eng.backend)
    split = runs.check("drill", c["paged_attention"])
    _check_outs("drill", outs, new, vocab, ref)
    flagged = [w for w, st in widths if 1 in st]
    if drill.get("stages") != (4, 2) or not flagged or \
            min(flagged) >= eng.prefill_rows:
        raise AssertionError(f"drill: {drill}; widths while stage 1 was "
                             f"flagged {flagged} of {eng.prefill_rows}")
    info["drill"] = dict(drill, wall_s=wall, prefill_rows=eng.prefill_rows,
                         min_rows_flagged=min(flagged),
                         ticks_flagged=len(flagged),
                         paged_launches=c["paged_attention"])
    log(f"[res-drill] 4 stages, stage 1 delayed "
        f"{RES_DELAY_S * 1e3:.0f} ms on {RES_DELAY_TICKS} decode ticks: "
        f"flagged at {len(flagged)} admissions, prefill rows down to "
        f"{min(flagged)} of {eng.prefill_rows}; device 3 silent after step "
        f"{RES_KILL_STEP}, declared dead at step {drill['step']} (timeout "
        f"{RES_TIMEOUT} steps), resharded {drill['stages'][0]} -> "
        f"{drill['stages'][1]} in "
        f"{sum(drill['seconds'].values()) * 1e3:.1f} ms; all streams equal "
        f"the local engine's; paged launches {c['paged_attention']} = "
        f"{split}")
    del llm, eng

    # -- runs 4 and 5: online, prefix cache, threaded pump + SLO ------------
    rng = np.random.RandomState(SEED + 3)
    system = [int(t) for t in rng.randint(1, vocab, RES_SYSTEM)]
    oprompts, osps = _yi_requests(np, vocab, n_req, SERVE_PROMPTS, new,
                                  head=system)

    def online_llm(**kw):
        return engine(backend="local", n_stages=2, mb_size=SERVE_MB,
                      num_microbatches=1, pool=PoolConfig(
                          page_size=SERVE_PAGE,
                          n_local_pages=SERVE_MB * RES_ONLINE_MAX_PAGES + 1,
                          max_pages_per_seq=RES_ONLINE_MAX_PAGES), **kw)
    llm = online_llm()
    reset_counts()
    t0 = time.perf_counter()
    oref = llm.generate(oprompts, osps)
    torch.cuda.synchronize()
    offline_wall = time.perf_counter() - t0
    c = counts["yi-9b online offline"] = read_counts()
    _check_outs("online offline", oref, new, vocab)
    ticks = llm.stats()["decode_ticks"]
    tick_s = llm.stats()["decode_time_s"] / ticks
    if c["paged_attention"] != ticks * cfg.num_layers:
        raise AssertionError(f"online offline: {c['paged_attention']} paged "
                             f"launches for {ticks} ticks")
    del llm
    base_rate = n_req / serve_wall
    online = {}
    for label, mult, threaded in (("0.5x", 0.5, False),
                                  ("1.5x", 1.5, False),
                                  ("threaded slo", 1.5, True)):
        kw = dict(prefix_cache=True)
        if threaded:
            kw["slo"] = SLOConfig(ttft_target_s=RES_SLO_TTFT,
                                  itl_target_s=0.75 * tick_s)
        llm = online_llm(**kw)
        eng = llm.engine
        fracs = []
        if threaded:
            orig_frac = eng.slo.budget_frac

            def frac(wait, _orig=orig_frac):
                f = _orig(wait)
                fracs.append(f)
                return f
            eng.slo.budget_frac = frac
        front = OnlineLLM(llm=llm)
        arrivals = np.cumsum(np.random.RandomState(SEED + 4).exponential(
            1.0 / (mult * base_rate), n_req))
        reset_counts()
        if threaded:
            front.start()
        streams, nxt = [], 0
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            while nxt < n_req and arrivals[nxt] <= now:
                streams.append(front.submit(oprompts[nxt], osps[nxt]))
                nxt += 1
            if threaded or not front.step():
                if nxt >= n_req:
                    break
                time.sleep(min(0.005, max(0.0, arrivals[nxt] -
                                          (time.perf_counter() - t0))))
        outs = [s.result() for s in streams]
        closed = front.close(timeout=30.0) if threaded else True
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts[f"yi-9b online {label}"] = read_counts()
        rep = llm.stats()
        graph_books(torch, f"res-online {label}", eng.backend, rep)
        _check_outs(f"online {label}", outs, new, vocab, oref)
        if not closed or rep["prefix_hit_rate"] <= 0 or \
                c["paged_attention"] != rep["decode_ticks"] * cfg.num_layers:
            raise AssertionError(
                f"online {label}: close() {'ended' if closed else 'hung'}, "
                f"prefix hit rate {rep['prefix_hit_rate']}, "
                f"{c['paged_attention']} paged launches for "
                f"{rep['decode_ticks']} ticks")
        # from the scheduled arrival, not the submission: a request that
        # arrives during a step is submitted when the step returns
        ttft = [s.first_token_time - (t0 + a)
                for s, a in zip(streams, arrivals)]
        lag = [s.submit_time - (t0 + a) for s, a in zip(streams, arrivals)]
        itl = [x for s in streams for x in s.inter_token_s()]
        q = {f"{name}_p{p}_s": float(np.percentile(v, p))
             for name, v in (("ttft", ttft), ("itl", itl)) for p in (50, 99)}
        q.update(ttft_max_s=max(ttft), itl_max_s=max(itl),
                 submit_lag_max_s=max(lag))
        online[label] = dict(
            rate_req_s=mult * base_rate, wall_s=wall, **q,
            prefix_hit_rate=rep["prefix_hit_rate"],
            prefix_hits=rep["prefix_hits"],
            prefill_tokens_skipped=rep["prefix_hit_tokens"],
            prefill_tokens=rep["prefill_tokens"],
            evictions=eng.prefix_cache.evictions,
            decode_ticks=rep["decode_ticks"],
            paged_launches=c["paged_attention"])
        line = (f"[res-online] {label}: {n_req} requests, "
                f"{RES_SYSTEM}-token shared system prompt, Poisson "
                f"{mult * base_rate:.3f} req/s ({mult}x the yi-9b phase's "
                f"offline {base_rate:.3f}) on {card}: TTFT p50 "
                f"{q['ttft_p50_s']:.3f} s p99 {q['ttft_p99_s']:.3f} s max "
                f"{q['ttft_max_s']:.3f} s (from the scheduled arrival; "
                f"submissions up to {q['submit_lag_max_s'] * 1e3:.1f} ms "
                "late), ITL "
                f"p50 {q['itl_p50_s'] * 1e3:.1f} ms p99 "
                f"{q['itl_p99_s'] * 1e3:.1f} ms; prefix hit rate "
                f"{rep['prefix_hit_rate']:.3f}, {rep['prefix_hit_tokens']} "
                f"prefill tokens skipped ({rep['prefill_tokens']} computed), "
                f"{eng.prefix_cache.evictions} evictions; streams equal the "
                f"offline run's without the cache")
        if threaded:
            online[label].update(slo_itl_target_s=0.75 * tick_s,
                                 slo_ttft_target_s=RES_SLO_TTFT,
                                 budget_frac_min=min(fracs),
                                 budget_frac_calls=len(fracs),
                                 closed=closed)
            line += (f"; threaded pump, SLO itl {0.75 * tick_s * 1e3:.1f} "
                     f"ms / ttft {RES_SLO_TTFT:.1f} s: budget fraction min "
                     f"{min(fracs):.3f} over {len(fracs)} admissions, "
                     "close() returned in time")
        log(line)
        del llm, eng, front
    info["online"] = dict(online, offline_wall_s=offline_wall,
                          base_rate_req_s=base_rate)
    return counts, info


# ---------------------------------------------------------------------------
# phase 12: the flight recorder and the strict auditor
# ---------------------------------------------------------------------------

# the recorder's recording methods (its readers, link_ledger, summary and
# request_trace, are not timed)
RECORDING = ("span", "instant", "step_phase", "pipe_tick", "link_send",
             "tick_stall", "stage_busy", "offload_swap_out", "offload_swap_in",
             "prefix_event", "slo_budget", "fault", "reshard_span",
             "request_submit", "request_admit", "request_first_token",
             "request_tokens", "request_chunk", "request_pages",
             "request_prefix_hit", "request_finish", "request_stream_submit",
             "request_delivery")
AUDIT_HOOKS = ("after_submit", "after_step", "after_reshard")


class _HookClock:
    """Host seconds an engine spends inside its flight recorder's recording
    calls and its auditor's hooks: each is wrapped, on the instances the
    engine, backend, transport and offloaders share, with two
    ``perf_counter`` reads (counted in the figure, so it bounds the cost
    from above).  ``calls[name]`` counts each hook's calls."""

    def __init__(self, engine):
        self.seconds = {"recorder": 0.0, "auditor": 0.0}
        self.calls = {}
        if engine.recorder is not None:
            for name in RECORDING:
                self._wrap(engine.recorder, name, "recorder")
        if engine.auditor is not None:
            for name in AUDIT_HOOKS:
                self._wrap(engine.auditor, name, "auditor")

    def _wrap(self, obj, name, kind):
        fn = getattr(obj, name)
        self.calls[name] = 0

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds[kind] += time.perf_counter() - t0
                self.calls[name] += 1
        setattr(obj, name, timed)

    def report(self, engine, steps: int) -> dict:
        """The run's recorder and auditor figures (None where off)."""
        out = {"recorder": None, "auditor": None}
        rec, aud = engine.recorder, engine.auditor
        if rec is not None:
            out["recorder"] = {
                "events": len(rec.events), "dropped": rec.dropped,
                "requests": len(rec.requests),
                "calls": sum(self.calls[n] for n in RECORDING),
                "host_us_a_step": self.seconds["recorder"] / steps * 1e6}
        if aud is not None:
            out["auditor"] = {
                "checks": aud.checks,
                "host_ms_a_check": self.seconds["auditor"] / aud.checks
                * 1e3,
                "host_ms_a_step": self.seconds["auditor"] / steps * 1e3}
        return out


def _cost_text(costs) -> str:
    parts = []
    r, a = costs["recorder"], costs["auditor"]
    if r is not None:
        parts.append(f"recorder {r['events']} events, {r['dropped']} "
                     f"dropped, {r['calls']} calls, "
                     f"{r['host_us_a_step']:.1f} us a step")
    if a is not None:
        parts.append(f"auditor {a['checks']} checks, "
                     f"{a['host_ms_a_check']:.3f} ms a check")
    return "; ".join(parts) or "recorder and auditor off"


def _event_counts(rec) -> dict:
    out = {}
    for e in rec.events:
        out[e.name] = out.get(e.name, 0) + 1
    return out


def _trace_llm(torch, params, **kw):
    """Full-width yi-9b (bf16, the serve phases' weights) behind ``LLM``
    with the trace phase's engine settings and ``kw``."""
    import gc

    from repro_torch.config import get_arch
    from repro_torch.models.common import Runtime
    from repro_torch.serving.llm import LLM, EngineConfig

    gc.collect()
    torch.cuda.empty_cache()
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    return LLM(get_arch("yi-9b"),
               config=EngineConfig(seed=SEED, max_prefill_tokens_per_tick=256,
                                   **kw),
               params=params, rt=rt, reduced=False, device="cuda")


def _check_traced(outs, tag, new: int = SERVE_NEW):
    """Every request carries a full request trace."""
    missing = [o.request_id for o in outs if not o.trace
               or len(o.trace["token_times"]) != new]
    if missing:
        raise AssertionError(f"{tag}: requests {missing} have no full "
                             "request trace")


def phase_trace_local(torch, np, card: str, params, serve_run):
    """``[trace-local]`` of phase 12: the yi-9b phase's local engine six
    times in turns (off, on, strict, strict, on, off): streams and paged
    launches equal the yi-9b phase's (``serve_run``); tok/s and the
    recorder's and auditor's host cost.  Returns the runs' launch counts
    and their figures.  Alone, after phase 7 (``phase_serve``):

        python -c "import torch, numpy as np, chip_smoke as c; \\
            line, _ = c.phase_card(torch); p = c.yi_params(torch); \\
            (counts, _, outs) = c.phase_serve(torch, np, line, p); \\
            c.phase_trace_local(torch, np, line, p, \\
                dict(outs=outs, counts=counts))"
    """
    from repro_torch.config import get_arch
    from repro_torch.obs import chrome_trace_events, validate_chrome_trace
    from repro_torch.serving.kv_cache import PoolConfig

    vocab, new = get_arch("yi-9b").vocab_size, SERVE_NEW
    counts = {}
    t0 = time.perf_counter()
    runs = []
    want_paged = serve_run["counts"]["paged_attention"]
    for i, turn in enumerate(TRACE_TURNS):
        llm = _trace_llm(torch, params, mb_size=SERVE_MB,
                         num_microbatches=SERVE_N_MB,
                         pool=PoolConfig(page_size=SERVE_PAGE,
                                         n_local_pages=SERVE_POOL_PAGES,
                                         max_pages_per_seq=SERVE_MAX_PAGES),
                         trace=turn != "off", strict=turn == "strict")
        clock = _HookClock(llm.engine)
        tag = f"trace-local {i + 1} {turn}"
        outs, rep, c = _serve_yi(torch, np, llm, tag, card)
        _check_outs(tag, outs, new, vocab, serve_run["outs"])
        if c["paged_attention"] != want_paged or c["flash_attention"]:
            raise AssertionError(f"{tag}: {c} launches, the yi-9b phase's "
                                 f"{want_paged} paged and no flash")
        if turn != "off":
            _check_traced(outs, tag)
            errs = validate_chrome_trace(
                chrome_trace_events(llm.engine.recorder))
            if errs:
                raise AssertionError(f"{tag}: invalid trace: {errs[:3]}")
        costs = clock.report(llm.engine, rep["steps"])
        runs.append(dict(turn=turn, decode_tok_per_s=rep["decode_tok_per_s"],
                         prefill_tok_per_s=rep["prefill_tok_per_s"],
                         wall_s=rep["generate_wall_s"], steps=rep["steps"],
                         paged_launches=c["paged_attention"], **costs))
        counts[f"yi-9b traced {i + 1} {turn}"] = c
        log(f"[trace-local] run {i + 1} ({turn}) on {card}: decode "
            f"{rep['decode_tok_per_s']:.1f} tok/s, prefill "
            f"{rep['prefill_tok_per_s']:.1f} tok/s, wall "
            f"{rep['generate_wall_s']:.3f} s, {rep['steps']} steps; "
            f"{_cost_text(costs)}; streams and {c['paged_attention']} paged "
            "launches equal the yi-9b phase's")
        del llm
    by = {}
    for r in runs:
        by.setdefault(r["turn"], []).append(r)
    summary = {turn: {k: [r[k] for r in rs] for k in
                      ("decode_tok_per_s", "prefill_tok_per_s", "wall_s")}
               for turn, rs in by.items()}
    log("[trace-local] decode tok/s by mode on " + card + ": " + "; ".join(
        f"{turn} " + " / ".join(f"{v:.1f}" for v in s["decode_tok_per_s"])
        for turn, s in summary.items()) + "; prefill tok/s: " + "; ".join(
        f"{turn} " + " / ".join(f"{v:.1f}" for v in s["prefill_tok_per_s"])
        for turn, s in summary.items()))
    return counts, {"runs": runs, "by_mode": summary,
                    "wall_s": time.perf_counter() - t0}


def phase_trace(torch, np, card: str, params, serve_run, int8_outs,
                local_run, res_counts):
    """Phase 12 on full-width yi-9b (bf16, the serve phases' weights and 20
    requests), each run held against an earlier phase's untraced one:

    1. ``[trace-local]`` (``phase_trace_local``);
    2. ``[trace-pipe]``: 4 stages, int8 wire, 64 ms links, the offloaded
       pools, traced and audited: streams equal the pipeline phase's
       untraced int8 run; the recorded ledger equals the transport's books
       bitwise; the Chrome trace, written under ``build/trace/`` and read
       back, is valid; one swap window a swap; paged launches the stage
       runs x 12;
    3. ``[trace-res]``: phase 11's fault storm and reshard 2 -> 4 -> 1,
       traced and audited: streams equal the local engine's, the recorded
       drops equal the lost work (3 + 2), one drain and one rebuild span a
       reshard, ``after_reshard`` passed each time."""
    from repro_torch.config import get_arch
    from repro_torch.distributed.elastic import FaultPlan
    from repro_torch.distributed.transport import SimulatedLinkTransport
    from repro_torch.obs import validate_chrome_trace, write_chrome_trace
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import RequestOutput

    vocab, new = get_arch("yi-9b").vocab_size, SERVE_NEW
    info = {}
    counts, info["local"] = phase_trace_local(torch, np, card, params,
                                              serve_run)

    def llm_of(**kw):
        return _trace_llm(torch, params, **kw)

    traced = _check_traced


    # -- run 2: 4 stages, int8 wire, 64 ms links, offloaded pools -----------
    t0 = time.perf_counter()
    llm = llm_of(mb_size=PIPE_MB, num_microbatches=PIPE_INT8_STAGES,
                 pool=PoolConfig(page_size=SERVE_PAGE, n_local_pages=OFF_LOCAL,
                                 n_global_pages=OFF_GLOBAL,
                                 max_pages_per_seq=SERVE_MAX_PAGES),
                 backend="pipelined", n_stages=PIPE_INT8_STAGES,
                 wire_dtype="int8", transport=SimulatedLinkTransport.uniform(
                     PIPE_INT8_STAGES, PIPE_LINK), trace=True, strict=True)
    eng = llm.engine
    clock = _HookClock(eng)
    outs, rep, c = _serve_yi(torch, np, llm, "trace-pipe", card)
    _check_outs("trace-pipe", outs, new, vocab, int8_outs)
    traced(outs, "trace-pipe")
    be, rec = eng.backend, eng.recorder
    stage_runs = _StageRuns()
    stage_runs.add(be)
    split = stage_runs.check("trace-pipe", c["paged_attention"])
    books = rep["transport"]
    ledger = rec.link_ledger()
    if rec.dropped or ledger["wire_bytes"] != books["wire_bytes"] or \
            ledger["sends"] != books["link_sends"] or \
            ledger["stall_s"] != books["link_stall_s"]:
        raise AssertionError(f"trace-pipe: ledger {ledger} ({rec.dropped} "
                             f"dropped) against the books {books}")
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / "yi9b_pipe_int8.json"
    write_chrome_trace(rec, str(path))
    back = json.loads(path.read_text())
    errs = validate_chrome_trace(back)
    sent = sum(e["args"]["nbytes"] for e in back["traceEvents"]
               if e.get("ph") == "b")
    if errs or sent != books["wire_bytes"]:
        raise AssertionError(f"trace-pipe: {path} has {len(errs)} problems "
                             f"({errs[:3]}); its transfers sum to {sent} "
                             f"bytes against {books['wire_bytes']}")
    ev = _event_counts(rec)
    swaps = be.swap_count
    if ev.get("swap_in", 0) != swaps or swaps == 0:
        raise AssertionError(f"trace-pipe: {ev.get('swap_in', 0)} swap "
                             f"windows recorded for {swaps} swaps")
    costs = clock.report(eng, rep["steps"])
    info["pipe"] = dict(
        decode_tok_per_s=rep["decode_tok_per_s"],
        prefill_tok_per_s=rep["prefill_tok_per_s"],
        virtual_decode_tok_per_s=rep["virtual_decode_tok_per_s"],
        wall_s=rep["generate_wall_s"], steps=rep["steps"],
        decode_ticks=rep["decode_ticks"], prefill_ticks=be.prefill_ticks,
        ledger=ledger, books=books, swaps=swaps,
        swap_outs=ev.get("swap_out", 0), trace_file=str(path.relative_to(
            ROOT)), trace_events=len(back["traceEvents"]),
        trace_bytes=path.stat().st_size, paged_launches=c["paged_attention"],
        events_by_name=ev, **costs)
    counts["yi-9b traced pipelined int8"] = c
    log(f"[trace-pipe] {PIPE_INT8_STAGES} stages, int8 wire, "
        f"{PIPE_LINK * 1e3:.0f} ms links, offloaded pools, trace and strict "
        f"on {card}: all {len(outs)} streams equal the pipeline phase's "
        f"untraced int8 run; decode {rep['decode_tok_per_s']:.1f} tok/s, "
        f"prefill {rep['prefill_tok_per_s']:.1f} tok/s, virtual decode "
        f"{rep['virtual_decode_tok_per_s']:.1f} tok/s, wall "
        f"{rep['generate_wall_s']:.3f} s; {_cost_text(costs)}")
    log(f"[trace-pipe] ledger == books bitwise: {ledger['wire_bytes']} wire "
        f"bytes, {ledger['sends']} sends, stall {ledger['stall_s']!r} s; "
        f"{path.relative_to(ROOT)}: {len(back['traceEvents'])} events "
        f"({path.stat().st_size} bytes), valid, its transfers sum to the "
        f"wire bytes; {swaps} swaps = {ev.get('swap_in', 0)} swap windows "
        f"({ev.get('swap_out', 0)} swap-outs); paged launches "
        f"{c['paged_attention']} = {split}")
    del llm, eng, be, rec
    info["pipe"]["phase_wall_s"] = time.perf_counter() - t0

    # -- run 3: phase 11's fault storm and reshard, traced and audited ------
    t0 = time.perf_counter()
    ref = local_run["outs"]
    prompts, sps = _yi_requests(np, vocab, SERVE_REQUESTS, SERVE_PROMPTS,
                                new)

    def res_llm(**kw):
        return llm_of(mb_size=PIPE_MB, num_microbatches=PIPE_N_MB,
                      pool=PoolConfig(page_size=SERVE_PAGE,
                                      n_local_pages=OFF_LOCAL,
                                      n_global_pages=OFF_GLOBAL,
                                      max_pages_per_seq=SERVE_MAX_PAGES),
                      backend="pipelined", n_stages=RES_STAGES, trace=True,
                      strict=True, **kw)

    def drive(llm, hook):
        eng = llm.engine
        seqs = eng.submit(llm._make_requests(prompts, sps))
        reset_counts()
        t1 = time.perf_counter()
        step = 0
        while eng.step():
            step += 1
            hook(step)
        torch.cuda.synchronize()
        outs = [RequestOutput.from_seq(
            s, trace=eng.request_trace(s.request.request_id)) for s in seqs]
        return outs, time.perf_counter() - t1, step

    delays = [f"delay@decode:{t}:1:{RES_DELAY_S}"
              for t in range(RES_DELAY_FROM,
                             RES_DELAY_FROM + RES_DELAY_TICKS)]
    plan = FaultPlan.parse(list(RES_DROPS) + delays)
    llm = res_llm(fault_plan=plan)
    eng = llm.engine
    clock = _HookClock(eng)
    outs, wall, steps = drive(llm, lambda step: None)
    c = counts["yi-9b traced fault storm"] = read_counts()
    rep = llm.stats()
    _check_outs("trace-storm", outs, new, vocab, ref)
    traced(outs, "trace-storm")
    stage_runs = _StageRuns()
    stage_runs.add(eng.backend)
    stage_runs.check("trace-storm", c["paged_attention"])
    lost = (rep["decode_ticks_lost"], rep["prefill_chunks_lost"])
    ev = _event_counts(eng.recorder)
    untraced = res_counts["yi-9b fault storm"]["paged_attention"]
    if lost != (3, 2) or ev.get("fault_drop", 0) != sum(lost) or \
            ev.get("fault_recover", 0) != sum(lost) or \
            ev.get("fault_delay", 0) != RES_DELAY_TICKS or \
            c["paged_attention"] != untraced:
        raise AssertionError(
            f"trace-storm: lost {lost}, recorded {ev.get('fault_drop', 0)} "
            f"drops, {ev.get('fault_recover', 0)} recoveries, "
            f"{ev.get('fault_delay', 0)} delays; paged launches "
            f"{c['paged_attention']} against phase 11's {untraced}")
    costs = clock.report(eng, steps)
    info["storm"] = dict(lost=lost, fault_events={
        k: ev.get(k, 0) for k in ("fault_drop", "fault_recover",
                                  "fault_delay")}, wall_s=wall, steps=steps,
        paged_launches=c["paged_attention"], **costs)
    log(f"[trace-res] storm, trace and strict on {card}: streams equal the "
        f"local engine's; lost {lost[0]} decode ticks + {lost[1]} prefill "
        f"chunks = {ev.get('fault_drop', 0)} recorded drops, "
        f"{ev.get('fault_recover', 0)} recoveries, "
        f"{ev.get('fault_delay', 0)} delays; paged launches "
        f"{c['paged_attention']} (phase 11: {untraced}); wall {wall:.3f} s; "
        f"{_cost_text(costs)}")
    del llm, eng

    llm = res_llm()
    eng = llm.engine
    clock = _HookClock(eng)
    stage_runs = _StageRuns()

    def reshard_hook(step):
        if step not in RES_RESHARD_STEPS:
            return
        old = eng.backend
        kw = dict(n_stages=4) if step == RES_RESHARD_STEPS[0] \
            else dict(live_devices=1)
        eng.reshard(**kw)
        stage_runs.add(old)
        holders = [eng.backend.transport.recorder,
                   *(o.recorder for o in eng.backend.stage_offloaders)]
        if any(r is not eng.recorder for r in holders):
            raise AssertionError(f"trace-reshard: the rebuilt pipe at step "
                                 f"{step} lost the engine's recorder")
    outs, wall, steps = drive(llm, reshard_hook)
    c = counts["yi-9b traced reshard"] = read_counts()
    stage_runs.add(eng.backend)
    split = stage_runs.check("trace-reshard", c["paged_attention"])
    _check_outs("trace-reshard", outs, new, vocab, ref)
    traced(outs, "trace-reshard")
    rep = llm.stats()
    ev = _event_counts(eng.recorder)
    spans = [(e.name, dict(e.data)) for e in eng.recorder.events
             if e.track == "reshard"]
    passed = clock.calls["after_reshard"]
    if rep["reshards"] != 2 or ev.get("reshard_drain", 0) != 2 or \
            ev.get("reshard_rebuild", 0) != 2 or passed != 2:
        raise AssertionError(f"trace-reshard: {rep['reshards']} reshards, "
                             f"spans {spans}, after_reshard passed {passed} "
                             "times")
    costs = clock.report(eng, steps)
    info["reshard"] = dict(spans=[[n, d] for n, d in spans],
                           after_reshard=passed, wall_s=wall, steps=steps,
                           paged_launches=c["paged_attention"],
                           untraced_paged_launches=res_counts[
                               "yi-9b reshard"]["paged_attention"], **costs)
    log(f"[trace-res] reshard 2 -> 4 -> 1, trace and strict on {card}: "
        f"streams equal the local engine's; spans "
        + ", ".join(f"{n}{d}" for n, d in spans)
        + f"; after_reshard passed {passed} times; paged launches "
        f"{c['paged_attention']} = {split} (phase 11: "
        f"{info['reshard']['untraced_paged_launches']}); wall {wall:.3f} s; "
        f"{_cost_text(costs)}")
    del llm, eng
    info["res_phase_wall_s"] = time.perf_counter() - t0
    return counts, info


def phase_trace_gemma(torch, np, card: str, params, gemma_outs,
                      gemma_counts):
    """``[trace-gemma]``: the gemma3 phase's engine and requests on its
    weights, traced and audited (the exact-prefill branch of the engine's
    step): streams, flash and paged launches equal the gemma3 phase's."""
    from repro_torch.config import get_arch
    from repro_torch.models.common import Runtime
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import LLM, EngineConfig

    cfg = get_arch("gemma3-12b")
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    llm = LLM(cfg, config=EngineConfig(
        mb_size=GEMMA_MB, num_microbatches=1,
        pool=PoolConfig(page_size=GEMMA_PAGE, n_local_pages=GEMMA_POOL_PAGES,
                        max_pages_per_seq=GEMMA_MAX_PAGES),
        seed=SEED, prefill_mode="auto", trace=True, strict=True),
        params=params, rt=rt, reduced=False, device="cuda")
    prompts, sps = _yi_requests(np, cfg.vocab_size, GEMMA_REQUESTS,
                                GEMMA_PROMPTS, GEMMA_NEW)
    clock = _HookClock(llm.engine)
    reset_counts()
    t0 = time.perf_counter()
    outs = llm.generate(prompts, sps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = read_counts()
    rep = llm.stats()
    _check_outs("trace-gemma", outs, GEMMA_NEW, cfg.vocab_size, gemma_outs)
    if any(not o.trace or len(o.trace["token_times"]) != GEMMA_NEW
           for o in outs):
        raise AssertionError("trace-gemma: a request has no full trace")
    if c != gemma_counts or c["flash_attention"] != \
            GEMMA_REQUESTS * cfg.num_layers:
        raise AssertionError(f"trace-gemma: launches {c}, the gemma3 "
                             f"phase's {gemma_counts}")
    costs = clock.report(llm.engine, rep["steps"])
    log(f"[trace-gemma] gemma3-12b, exact prefill, trace and strict on "
        f"{card}: all {len(outs)} streams equal the gemma3 phase's; decode "
        f"{rep['decode_tok_per_s']:.1f} tok/s, prefill "
        f"{rep['prefill_tok_per_s']:.1f} tok/s, wall {wall:.3f} s, "
        f"{rep['steps']} steps; flash launches {c['flash_attention']}, paged "
        f"{c['paged_attention']} (the gemma3 phase's {gemma_counts}); "
        f"{_cost_text(costs)}")
    info = dict(decode_tok_per_s=rep["decode_tok_per_s"],
                prefill_tok_per_s=rep["prefill_tok_per_s"], wall_s=wall,
                steps=rep["steps"], launches=c, **costs)
    return c, info


# ---------------------------------------------------------------------------
# phase 13: the other architectures (MoE, xLSTM, the dense configs)
# ---------------------------------------------------------------------------


def _arch_rt(torch, dtype):
    from repro_torch.models.common import Runtime
    return Runtime(param_dtype=dtype, compute_dtype=dtype)


def _free_card(torch):
    """Drop what earlier phases left (their weights, pools and rings) before
    a phase makes tens of GB of weights."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_param_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


class _DropCounter:
    """The (token, choice) pairs the MoE capacity drops over one run,
    counted on the card (no host sync) by wrapping ``moe.dispatch``, which
    ``moe_ffn`` looks up at each call."""

    def __init__(self, torch):
        from repro_torch.models import moe as moe_lib
        self.lib, self.orig = moe_lib, moe_lib.dispatch
        self.dropped = torch.zeros((), dtype=torch.int64, device="cuda")
        self.pairs = torch.zeros((), dtype=torch.int64, device="cuda")

    def __enter__(self):
        def counted(x, topi, moe, expert_shard=None):
            out = self.orig(x, topi, moe, expert_shard)
            self.dropped += (~out[1]).sum()
            self.pairs += out[1].numel()
            return out
        self.lib.dispatch = counted
        return self

    def __exit__(self, *exc):
        self.lib.dispatch = self.orig

    def read(self):
        return int(self.dropped), int(self.pairs)


def chunk_launches(backend, cfg) -> int:
    """The chunk kernel's launches over a local backend's prefill chunks:
    one a paged layer a chunk, and one more a layer for each further
    launch of 16 heads that a G above 16 takes (``kernels.groups``)."""
    from repro_torch.kernels import chunk_attention as ca
    from repro_torch.kernels import groups
    from repro_torch.models.model import PAGED_KINDS
    layers = sum(k in PAGED_KINDS for k in cfg.layer_kinds())
    per_layer = len(groups.group_plan(cfg.num_heads // cfg.num_kv_heads,
                                      ca.GROUP_SIZES))
    return backend.prefill_chunks * layers * per_layer


def _arch_serve(torch, np, tag, cfg, params, rt, econf, n_req, prompt_range,
                max_new):
    """``LLM.generate`` over ``n_req`` requests of ``prompt_range`` tokens,
    greedy and sampled in turn; every request must finish at full length
    with finite log-probs.  Returns (llm, outs, counts, report, wall)."""
    from repro_torch.serving.llm import LLM
    from repro_torch.serving.request import SamplingParams
    llm = LLM(cfg, config=econf, params=params, rt=rt, reduced=False,
              device="cuda")
    rng = np.random.RandomState(SEED)
    lens = rng.randint(prompt_range[0], prompt_range[1] + 1, n_req)
    prompts = [list(rng.randint(1, cfg.vocab_size, n)) for n in lens]
    sps = [SamplingParams(temperature=0.0, max_new_tokens=max_new,
                          logprobs=True) if i % 2 == 0 else
           SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                          max_new_tokens=max_new, logprobs=True)
           for i in range(n_req)]
    spans = time_replays(torch, llm.engine.backend)
    reset_counts()
    t1 = time.perf_counter()
    outs = llm.generate(prompts, sps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = read_counts()
    rep = llm.stats()
    rep["graphs"] = graph_books(torch, tag, llm.engine.backend, rep, spans)
    bad = [o.request_id for o in outs
           if not o.finished or len(o.token_ids) != max_new
           or not all(math.isfinite(x) for x in o.logprobs)
           or not all(0 <= t < cfg.vocab_size for t in o.token_ids)]
    if bad:
        raise AssertionError(f"{tag}: requests {bad} unfinished, short, or "
                             "with non-finite log-probs")
    log(f"[{tag}] {len(outs)}/{n_req} requests finished, {max_new} tokens "
        f"each; prompts {int(lens.min())}-{int(lens.max())} tokens "
        f"({int(lens.sum())} total); batch {llm.engine.mb_size}x"
        f"{llm.engine.num_microbatches}; "
        + (f"chunked prefill ({llm.engine.prefill_chunk} x "
           f"{llm.engine.prefill_rows} rows)" if llm.engine.chunked_prefill
           else "exact-length prefill"))
    log(f"[{tag}] decode_tok_per_s={rep['decode_tok_per_s']:.1f} "
        f"prefill_tok_per_s={rep['prefill_tok_per_s']:.1f} (engine phase "
        f"clocks; decode {rep['decode_time_s']:.3f}s, prefill "
        f"{rep['prefill_time_s']:.3f}s); wall {wall:.3f}s; decode ticks "
        f"{rep['decode_ticks']}; launches {counts}")
    return llm, outs, counts, rep, wall


def _arch_tick(torch, np, cfg, rt, params, backend):
    """Host and device ms (:func:`tick_split`) and the device's busy share
    of one local decode tick of ``mb_size`` rows at an
    ``ARCH_TICK_CTX``-token context on ``backend``'s full-width caches,
    ending in its one device-to-host transfer: replayed, as the engine's
    step runs it (``backend.decode``), and the eager step beside it."""
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.backend import LocalBackend
    from repro_torch.serving.sampler import RowSampling
    dev = torch.device("cuda")
    mb = backend.mb_size
    per_row = backend.pool.max_pages_per_seq
    table = 1 + np.arange(backend.batch * per_row,
                          dtype=np.int32).reshape(backend.batch, per_row)
    kvc.set_page_table(backend.caches, table)
    tokens = torch.randint(1, cfg.vocab_size, (mb,), dtype=torch.int32,
                           device=dev)
    pos = torch.full((mb,), ARCH_TICK_CTX, dtype=torch.int32, device=dev)
    zeros = torch.zeros((mb,), device=dev)
    ints = torch.zeros((mb,), dtype=torch.int32, device=dev)
    host_toks = tokens.cpu().numpy()
    host_pos = pos.cpu().numpy()
    greedy = RowSampling(keys=np.zeros(mb, np.int64),
                         steps=np.zeros(mb, np.int32),
                         temp=np.zeros(mb, np.float32),
                         top_k=np.zeros(mb, np.int32),
                         top_p=np.ones(mb, np.float32))

    @torch.inference_mode()
    def tick():
        toks, lps = LocalBackend._decode_fn(
            params, backend.caches, tokens, pos, 0, None, zeros, ints,
            zeros + 1, cfg=cfg, rt=rt, mb_size=mb, sampled=False)
        torch.stack([toks.float(), lps]).cpu()

    @torch.inference_mode()
    def replay():
        backend.decode(0, host_toks, host_pos, greedy)

    host_ms, dev_ms = tick_split(torch, replay, ARCH_TICK_STEPS)
    eager_host, eager_dev = tick_split(torch, tick, ARCH_TICK_STEPS)
    return {"tick_host_ms": host_ms, "tick_device_ms": dev_ms,
            "device_busy": dev_ms / host_ms, "eager_host_ms": eager_host,
            "eager_device_ms": eager_dev,
            "eager_device_busy": eager_dev / eager_host}


def _moe_tick_split(torch, cfg, params, rt, rows: int) -> dict:
    """One decode tick's MoE FFNs (``rows`` tokens through every layer)
    split into router, dispatch, expert products and combine, by CUDA
    events between the four calls; the card first spins long enough for
    the host to issue the whole tick, so each span is device time alone.
    The median of ``MOE_SPLIT_REPS`` ticks, beside the bytes of the
    weights the tick reads."""
    from repro_torch.models import moe as moe_lib
    dev = torch.device("cuda")
    x = torch.randn((rows, cfg.d_model), device=dev).to(rt.compute_dtype)

    @torch.inference_mode()
    def once():
        evs = []
        torch.cuda._sleep(MOE_SPLIT_SPIN_CYCLES)
        for layer in params["layers"]:
            w = layer["moe"]
            e = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            e[0].record()
            topv, topi, _ = moe_lib.router_probs(x, w["router"], cfg.moe)
            e[1].record()
            buf, keep, le, sl = moe_lib.dispatch(x, topi, cfg.moe)
            e[2].record()
            out = moe_lib._expert_ffn(buf, w["wg"], w["wu"], w["wd"])
            e[3].record()
            moe_lib.combine(out, topv, keep, le, sl, x.dtype)
            e[4].record()
            evs.append(e)
        torch.cuda.synchronize()
        return [sum(e[i].elapsed_time(e[i + 1]) for e in evs)
                for i in range(4)]

    once()
    runs = [once() for _ in range(MOE_SPLIT_REPS)]
    parts = ("router", "dispatch", "experts", "combine")
    split = {p: sorted(r[i] for r in runs)[len(runs) // 2]
             for i, p in enumerate(parts)}
    moe_bytes = sum(_param_bytes(layer["moe"]) for layer in params["layers"])
    # a decode tick reads every weight once, but only its rows of the
    # token embedding
    tick_bytes = _param_bytes(params) - _param_bytes(params["embed"]["tok"])
    split.update(moe_bytes=moe_bytes, tick_weight_bytes=tick_bytes,
                 moe_bound_ms=moe_bytes / HBM_BYTES_PER_S * 1e3,
                 tick_bound_ms=tick_bytes / HBM_BYTES_PER_S * 1e3,
                 rows=rows)
    return split


def _log_tick(tag, card, tick, counts, rep, kernel_per_tick):
    log(f"[{tag}] on {card}: decode tick of {tick['rows']} rows at "
        f"{ARCH_TICK_CTX} tokens, replayed: host {tick['tick_host_ms']:.3f} "
        f"ms, device {tick['tick_device_ms']:.3f} ms, device busy "
        f"{tick['device_busy']:.1%}; eager: host "
        f"{tick['eager_host_ms']:.3f} ms, device "
        f"{tick['eager_device_ms']:.3f} ms, device busy "
        f"{tick['eager_device_busy']:.1%}; paged launches "
        f"{counts['paged_attention']} (= {rep['decode_ticks']} ticks x "
        f"{kernel_per_tick})")


def _log_moe_split(tag, card, split):
    total = sum(split[p] for p in ("router", "dispatch", "experts",
                                   "combine"))
    log(f"[{tag}] MoE of one decode tick ({split['rows']} rows, every "
        f"layer) on {card}: router {split['router']:.3f} ms, dispatch "
        f"{split['dispatch']:.3f} ms, expert products "
        f"{split['experts']:.3f} ms, combine {split['combine']:.3f} ms "
        f"(sum {total:.3f} ms); expert and router weights "
        f"{split['moe_bytes'] / 1e9:.2f} GB -> at least "
        f"{split['moe_bound_ms']:.2f} ms at {HBM_BYTES_PER_S / 1e12:.2f} "
        f"TB/s; the whole tick's weights "
        f"{split['tick_weight_bytes'] / 1e9:.2f} GB -> at least "
        f"{split['tick_bound_ms']:.2f} ms")


def _moe_params(torch, cfg, rt, tag):
    from repro_torch.models import model as model_lib
    _free_card(torch)
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, SEED, rt, "cuda")
    torch.cuda.synchronize()
    log(f"[{tag}] {cfg.name} full width at {cfg.num_layers} layers: "
        f"{cfg.moe.num_experts} experts of {cfg.moe.d_expert}, top "
        f"{cfg.moe.experts_per_token}, capacity factor "
        f"{cfg.moe.capacity_factor}, renormalised "
        f"{cfg.moe.normalize_router_weights}, qk-norm {cfg.use_qk_norm}, "
        f"G = {cfg.num_heads // cfg.num_kv_heads}; "
        f"{_param_bytes(params) / 1e9:.2f} GB of bf16 weights (float32 "
        f"router) from seed {SEED} in {time.perf_counter() - t0:.1f}s")
    return params


def _moe_pool(mb, n_mb):
    from repro_torch.serving.kv_cache import PoolConfig
    return PoolConfig(page_size=MOE_PAGE, n_local_pages=mb * n_mb *
                      MOE_MAX_PAGES + 1, max_pages_per_seq=MOE_MAX_PAGES)


def phase_moe_phi(torch, np, card: str):
    """phi3.5-moe at full width and ``PHI_LAYERS`` layers: the yi-9b
    phase's 20 requests locally (chunked prefill, the paged kernel at
    G = 4), then the same engine pipelined through 2 stages."""
    import dataclasses

    from repro_torch.config import get_arch
    from repro_torch.serving.llm import EngineConfig

    cfg = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b"),
                              num_layers=PHI_LAYERS)
    rt = _arch_rt(torch, torch.bfloat16)
    params = _moe_params(torch, cfg, rt, "moe-phi")
    econf = EngineConfig(mb_size=MOE_MB, num_microbatches=1,
                         pool=_moe_pool(MOE_MB, 1), seed=SEED,
                         max_prefill_tokens_per_tick=256)
    with _DropCounter(torch) as drops:
        llm, outs, counts, rep, _ = _arch_serve(
            torch, np, "moe-phi", cfg, params, rt, econf, SERVE_REQUESTS,
            SERVE_PROMPTS, SERVE_NEW)
    local_drops = drops.read()
    if counts != {"paged_attention": rep["decode_ticks"] * PHI_LAYERS,
                  "flash_attention": 0, "rglru_scan": 0,
                  "chunk_attention": chunk_launches(llm.engine.backend,
                                                    cfg)}:
        raise AssertionError(f"moe-phi: launches {counts} for "
                             f"{rep['decode_ticks']} ticks x {PHI_LAYERS}")
    tick = dict(_arch_tick(torch, np, cfg, rt, params, llm.engine.backend),
                rows=MOE_MB)
    _log_tick("moe-phi", card, tick, counts, rep, PHI_LAYERS)
    split = _moe_tick_split(torch, cfg, params, rt, MOE_MB)
    _log_moe_split("moe-phi", card, split)
    del llm
    pconf = EngineConfig(mb_size=MOE_PIPE_MB, num_microbatches=MOE_PIPE_N_MB,
                         pool=_moe_pool(MOE_PIPE_MB, MOE_PIPE_N_MB),
                         seed=SEED, max_prefill_tokens_per_tick=256,
                         backend="pipelined", n_stages=2)
    with _DropCounter(torch) as drops:
        pl, pouts, pcounts, prep, _ = _arch_serve(
            torch, np, "moe-phi-pipe", cfg, params, rt, pconf,
            SERVE_REQUESTS, SERVE_PROMPTS, SERVE_NEW)
    pipe_drops = drops.read()
    be = pl.engine.backend
    want = be.decode_stage_runs * (PHI_LAYERS // 2)
    if pcounts["paged_attention"] != want or want == 0:
        raise AssertionError(f"moe-phi-pipe: {pcounts['paged_attention']} "
                             f"paged launches, want {be.decode_stage_runs} "
                             f"stage runs x {PHI_LAYERS // 2}")
    greedy = [i for i in range(SERVE_REQUESTS) if i % 2 == 0]
    same = sum(a == b for i in greedy for a, b in
               zip(outs[i].token_ids, pouts[i].token_ids))
    share = same / (len(greedy) * SERVE_NEW)
    log(f"[moe-phi-pipe] 2 stages, {MOE_PIPE_MB} x {MOE_PIPE_N_MB} slots: "
        f"paged launches {pcounts['paged_attention']} = "
        f"{be.decode_stage_runs} stage runs x {PHI_LAYERS // 2}; greedy "
        f"tokens equal to the local engine's: {same}/"
        f"{len(greedy) * SERVE_NEW} ({share:.1%}; a microbatch of "
        f"{MOE_PIPE_MB} rows "
        f"routes another N through the capacity than {MOE_MB}, so the "
        "streams may part)")
    log(f"[moe-phi] dropped assignments: local {local_drops[0]} of "
        f"{local_drops[1]} (token, choice) pairs, pipelined "
        f"{pipe_drops[0]} of {pipe_drops[1]}")
    summary = {"layers": PHI_LAYERS, "weight_gb": _param_bytes(params) / 1e9,
               "decode_tok_per_s": rep["decode_tok_per_s"],
               "prefill_tok_per_s": rep["prefill_tok_per_s"],
               "pipe_decode_tok_per_s": prep["decode_tok_per_s"],
               "pipe_prefill_tok_per_s": prep["prefill_tok_per_s"],
               "dropped": {"local": local_drops, "pipelined": pipe_drops},
               "pipe_greedy_equal_share": share, **tick, "moe_split": split}
    return {"phi3.5-moe": counts, "phi3.5-moe pipelined": pcounts}, summary


def phase_moe_qwen3(torch, np, card: str):
    """qwen3-moe at full width and ``QWEN_LAYERS`` layers: 128 experts,
    top 8 renormalised, qk-norm, the paged kernel at G = 16 (two launches
    of 8 a layer)."""
    import dataclasses

    from repro_torch.config import get_arch
    from repro_torch.serving.llm import EngineConfig

    cfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b"),
                              num_layers=QWEN_LAYERS)
    rt = _arch_rt(torch, torch.bfloat16)
    params = _moe_params(torch, cfg, rt, "moe-qwen3")
    econf = EngineConfig(mb_size=MOE_MB, num_microbatches=1,
                         pool=_moe_pool(MOE_MB, 1), seed=SEED,
                         max_prefill_tokens_per_tick=256)
    with _DropCounter(torch) as drops:
        llm, _, counts, rep, _ = _arch_serve(
            torch, np, "moe-qwen3", cfg, params, rt, econf, SERVE_REQUESTS,
            SERVE_PROMPTS, SERVE_NEW)
    dropped = drops.read()
    per_tick = QWEN_LAYERS * 2          # G = 16: two launches of 8
    if counts != {"paged_attention": rep["decode_ticks"] * per_tick,
                  "flash_attention": 0, "rglru_scan": 0,
                  "chunk_attention": chunk_launches(llm.engine.backend,
                                                    cfg)}:
        raise AssertionError(f"moe-qwen3: launches {counts} for "
                             f"{rep['decode_ticks']} ticks x {per_tick}")
    tick = dict(_arch_tick(torch, np, cfg, rt, params, llm.engine.backend),
                rows=MOE_MB)
    _log_tick("moe-qwen3", card, tick, counts, rep,
              f"{QWEN_LAYERS} layers x 2")
    split = _moe_tick_split(torch, cfg, params, rt, MOE_MB)
    _log_moe_split("moe-qwen3", card, split)
    log(f"[moe-qwen3] dropped assignments: {dropped[0]} of {dropped[1]} "
        "(token, choice) pairs")
    summary = {"layers": QWEN_LAYERS,
               "weight_gb": _param_bytes(params) / 1e9,
               "decode_tok_per_s": rep["decode_tok_per_s"],
               "prefill_tok_per_s": rep["prefill_tok_per_s"],
               "dropped": dropped, **tick, "moe_split": split}
    return {"qwen3-moe": counts}, summary


def phase_xlstm(torch, np, card: str):
    """xlstm-1.3b at full width and depth (42 mLSTM, 6 sLSTM layers):
    exact prefill in power-of-two buckets through the chunkwise mLSTM,
    ``XL_REQUESTS`` requests over ``XL_MB`` slots, so slots are reassigned
    and ``reset_slot`` clears both recurrent kinds' states."""
    from repro_torch.config import get_arch
    from repro_torch.models import model as model_lib
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import EngineConfig

    _free_card(torch)
    cfg = get_arch("xlstm-1.3b")
    kinds = cfg.layer_kinds()
    rt = _arch_rt(torch, torch.bfloat16)
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, SEED, rt, "cuda")
    torch.cuda.synchronize()
    dh = cfg.d_rnn // cfg.num_heads
    row_state = _param_bytes(model_lib.init_caches(cfg, 1, 1, rt, "cuda"))
    log(f"[xlstm] xlstm-1.3b full width and depth: {cfg.num_layers} layers "
        f"({kinds.count('mlstm')} mLSTM of {cfg.num_heads} heads x {dh}, "
        f"{kinds.count('slstm')} sLSTM), d_rnn {cfg.d_rnn}; "
        f"{_param_bytes(params) / 1e9:.2f} GB of weights from seed {SEED} in "
        f"{time.perf_counter() - t0:.1f}s; {row_state / 1e6:.1f} MB of "
        f"float32 state a row, {XL_MB} rows")
    econf = EngineConfig(
        mb_size=XL_MB, num_microbatches=1,
        pool=PoolConfig(page_size=16, n_local_pages=XL_MB * 8 + 1,
                        max_pages_per_seq=(XL_PROMPTS[1] + XL_NEW) // 16 + 1),
        seed=SEED, prefill_mode="auto")
    resets = {"n": 0}
    orig = kvc.reset_slot

    def counted(caches, slot):
        resets["n"] += 1
        return orig(caches, slot)

    kvc.reset_slot = counted
    try:
        llm, _, counts, rep, _ = _arch_serve(
            torch, np, "xlstm", cfg, params, rt, econf, XL_REQUESTS,
            XL_PROMPTS, XL_NEW)
    finally:
        kvc.reset_slot = orig
    if llm.engine.chunked_prefill:
        raise AssertionError("xlstm: 'auto' picked chunked prefill")
    if any(counts.values()):
        raise AssertionError(f"xlstm: kernel launches {counts} on an arch "
                             "with no attention and no RG-LRU layer")
    if resets["n"] != XL_REQUESTS or XL_REQUESTS <= XL_MB:
        raise AssertionError(f"xlstm: {resets['n']} slot resets for "
                             f"{XL_REQUESTS} requests over {XL_MB} slots")
    tick = dict(_arch_tick(torch, np, cfg, rt, params, llm.engine.backend),
                rows=XL_MB)
    _log_tick("xlstm", card, tick, counts, rep, 0)
    log(f"[xlstm] slot reuse: {resets['n']} resets (mLSTM c, n, m and sLSTM "
        f"c, n = 1e-6, h, m) for {XL_REQUESTS} requests over {XL_MB} slots")
    summary = {"weight_gb": _param_bytes(params) / 1e9,
               "row_state_mb": row_state / 1e6, "resets": resets["n"],
               "decode_tok_per_s": rep["decode_tok_per_s"],
               "prefill_tok_per_s": rep["prefill_tok_per_s"], **tick}
    return {"xlstm-1.3b": counts}, summary


def phase_minitron(torch, np, card: str):
    """minitron-4b at full width and depth: a short serve whose paged
    decode runs at G = 3 (24 heads over 8, zero-padded to 4)."""
    from repro_torch.config import get_arch
    from repro_torch.models import model as model_lib
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import EngineConfig

    _free_card(torch)
    cfg = get_arch("minitron-4b")
    rt = _arch_rt(torch, torch.bfloat16)
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, SEED, rt, "cuda")
    torch.cuda.synchronize()
    log(f"[minitron] minitron-4b full width and depth: {cfg.num_layers} "
        f"layers, {cfg.num_heads} heads over {cfg.num_kv_heads} (G = "
        f"{cfg.num_heads // cfg.num_kv_heads}); "
        f"{_param_bytes(params) / 1e9:.2f} GB of bf16 weights from seed "
        f"{SEED} in {time.perf_counter() - t0:.1f}s")
    econf = EngineConfig(
        mb_size=MT_MB, num_microbatches=1,
        pool=PoolConfig(page_size=MOE_PAGE, n_local_pages=MT_MB *
                        MOE_MAX_PAGES + 1, max_pages_per_seq=MOE_MAX_PAGES),
        seed=SEED, max_prefill_tokens_per_tick=256)
    llm, _, counts, rep, _ = _arch_serve(
        torch, np, "minitron", cfg, params, rt, econf, MT_REQUESTS,
        MT_PROMPTS, MT_NEW)
    if counts != {"paged_attention": rep["decode_ticks"] * cfg.num_layers,
                  "flash_attention": 0, "rglru_scan": 0,
                  "chunk_attention": chunk_launches(llm.engine.backend,
                                                    cfg)}:
        raise AssertionError(f"minitron: launches {counts} for "
                             f"{rep['decode_ticks']} ticks x "
                             f"{cfg.num_layers}")
    tick = dict(_arch_tick(torch, np, cfg, rt, params, llm.engine.backend),
                rows=MT_MB)
    _log_tick("minitron", card, tick, counts, rep, cfg.num_layers)
    summary = {"weight_gb": _param_bytes(params) / 1e9,
               "decode_tok_per_s": rep["decode_tok_per_s"],
               "prefill_tok_per_s": rep["prefill_tok_per_s"], **tick}
    return {"minitron-4b": counts}, summary


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


class _Routes:
    """The expert ids of every router call of a run, by wrapping
    ``moe.router_probs``."""

    def __init__(self):
        from repro_torch.models import moe as moe_lib
        self.lib, self.orig, self.ids = moe_lib, moe_lib.router_probs, []

    def __enter__(self):
        def recorded(x, w_router, moe):
            out = self.orig(x, w_router, moe)
            self.ids.append(out[1])
            return out
        self.lib.router_probs = recorded
        return self

    def __exit__(self, *exc):
        self.lib.router_probs = self.orig


def phase_arch_parity(torch, np):
    """The card's path against the port's CPU path (which the parity tests
    hold to the JAX package), float32, on one batch: a 2-layer full-width
    phi3.5-moe through a chunked prefill into paged pools and 8 paged
    decode steps (the paged kernel at G = 4 on the card), and an 8-layer
    full-width xlstm-1.3b (one pattern period) through an exact prefill
    and 8 decode steps.  Both devices decode the CPU's greedy tokens.  The
    routing ids must agree exactly, the logits within
    ``ARCH_PARITY_TOL``, xlstm's first layer's states within
    ``XLSTM_STATE_TOL`` (each layer's state error is printed); then the
    chunkwise mLSTM on the card against ``mlstm_sequential`` on the card
    at full width."""
    import dataclasses

    from repro_torch.config import get_arch
    from repro_torch.models import model as model_lib
    from repro_torch.models import xlstm as xlstm_lib
    from repro_torch.models.common import rms_norm
    from repro_torch.serving import kv_cache as kvc

    _free_card(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    rt = _arch_rt(torch, torch.float32)
    out = {}
    rng = np.random.RandomState(SEED)
    for arch, layers in (("phi3.5-moe-42b-a6.6b", 2), ("xlstm-1.3b", 8)):
        cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
        card_params = model_lib.init_params(cfg, SEED, rt, "cuda")
        cpu_params = _to(card_params, "cpu")
        P, R = PARITY_PROMPT, PARITY_ROWS
        tokens = rng.randint(1, cfg.vocab_size, (R, P)).astype(np.int64)
        last = np.asarray([P - 1, P - 9], np.int64)
        per_row = -(-(P + PARITY_STEPS) // 16)
        table = 1 + np.arange(R * per_row, dtype=np.int32).reshape(R, per_row)
        logits, routes, states, feed = {}, {}, {}, None
        for dev, params in (("cpu", cpu_params), ("cuda", card_params)):
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            with _Routes() as rec, torch.inference_mode():
                if cfg.moe is not None:
                    pool = kvc.PoolConfig(page_size=16,
                                          n_local_pages=R * per_row + 1,
                                          max_pages_per_seq=per_row)
                    caches = kvc.set_page_table(kvc.build_paged_caches(
                        cfg, R, pool, rt, dev), table)
                    lg, _ = model_lib.prefill_chunk(
                        params, t(tokens), caches, t(np.zeros(R, np.int32)),
                        t((last + 1).astype(np.int32)),
                        t(last.astype(np.int32)), cfg, rt)
                else:
                    caches = model_lib.init_caches(cfg, R, P + PARITY_STEPS,
                                                   rt, dev)
                    lg, _ = model_lib.prefill(params, {"tokens": t(tokens)}, cfg, rt,
                                              caches=caches,
                                              last_index=t(last))
                seq = [lg.cpu()]
                toks = [lg.argmax(-1).cpu()] if feed is None else None
                cur = last + 1
                for step in range(PARITY_STEPS):
                    nxt = toks[-1] if feed is None else feed[step]
                    lg, _ = model_lib.decode_step(
                        params, nxt.to(dev), caches,
                        t(cur.astype(np.int32)), cfg, rt)
                    seq.append(lg.cpu())
                    if feed is None:
                        toks.append(lg.argmax(-1).cpu())
                    cur = cur + 1
                if feed is None:
                    feed = toks
            logits[dev] = torch.stack(seq)
            routes[dev] = [r.cpu() for r in rec.ids]
            states[dev] = [{k: v.cpu() for k, v in layer.items()}
                           for layer in caches["layers"]]
        err = float((logits["cuda"] - logits["cpu"]).abs().max())
        scale = float(logits["cpu"].abs().max())
        argmax_eq = float((logits["cuda"].argmax(-1) ==
                           logits["cpu"].argmax(-1)).float().mean())
        tol = ARCH_PARITY_TOL[arch]
        entry = {"layers": layers, "logits_max_abs_err": err,
                 "logits_max_abs": scale, "argmax_equal_share": argmax_eq,
                 "tol": tol}
        if cfg.moe is not None:
            n = sum(r.numel() for r in routes["cpu"])
            same = sum(int((a == b).sum()) for a, b in
                       zip(routes["cpu"], routes["cuda"]))
            entry.update(routing_ids=n, routing_equal_share=same / max(n, 1))
            log(f"[arch-parity] {arch} {layers} layers: routing ids equal "
                f"{same}/{n} ({same / max(n, 1):.1%}) over "
                f"{len(routes['cpu'])} router calls")
            if len(routes["cpu"]) != len(routes["cuda"]) or same != n:
                raise AssertionError(f"arch-parity {arch}: routing ids "
                                     f"differ ({same}/{n} equal)")
        log(f"[arch-parity] {arch} {layers} layers, float32, card vs CPU: "
            f"logits max |diff| {err:.3g} (max |logit| {scale:.3g}, tol "
            f"{tol:g}) over the prefill and {PARITY_STEPS} decode steps; "
            f"argmax equal {argmax_eq:.1%}")
        if not err <= tol:
            raise AssertionError(f"arch-parity {arch}: logits differ by "
                                 f"{err:.3g} > {tol:g}")
        if cfg.moe is None:
            rel = [max(float((g[k] - w[k]).abs().max() /
                             w[k].abs().max().clamp(min=1e-30)) for k in w)
                   for g, w in zip(states["cuda"], states["cpu"])]
            log(f"[arch-parity] xlstm state error a layer after the run "
                f"(max |diff| / max |state|, card vs CPU): "
                + ", ".join(f"{r:.2g}" for r in rel))
            entry["state_rel_err_by_layer"] = rel
            if not rel[0] <= XLSTM_STATE_TOL:
                raise AssertionError(f"arch-parity {arch}: the first "
                                     f"layer's states differ by {rel[0]:.3g}")
        out[arch] = entry
        if cfg.moe is None:
            w = card_params["layers"][0]
            x = torch.randn((R, MLSTM_CARD_S, cfg.d_model), device="cuda")
            with torch.inference_mode():
                xm = rms_norm(x, w["ln1"], cfg.norm_eps) @ w["wm"]
                gates = xlstm_lib.mlstm_qkv_gates(xm, w, cfg.num_heads)
                hc, sc = xlstm_lib.mlstm_chunkwise(*gates, chunk=64)
                hs, ss = xlstm_lib.mlstm_sequential(*gates)
            h_err = float((hc - hs).abs().max() / hs.abs().max())
            c_err = float((sc["c"] - ss["c"]).abs().max() /
                          ss["c"].abs().max())
            log(f"[arch-parity] mLSTM chunkwise (chunk 64) vs sequential on "
                f"the card, float32, B={R}, S={MLSTM_CARD_S}, "
                f"{cfg.num_heads} heads x {cfg.d_rnn // cfg.num_heads}: "
                f"max |diff| / max |h| {h_err:.3g}, final C {c_err:.3g} "
                f"(tol {MLSTM_CARD_TOL:g})")
            if not (h_err <= MLSTM_CARD_TOL and c_err <= MLSTM_CARD_TOL):
                raise AssertionError("arch-parity: chunkwise mLSTM differs "
                                     "from the sequential one on the card")
            out["mlstm_chunkwise_vs_sequential"] = {"h": h_err, "c": c_err}
        del card_params, cpu_params
        _free_card(torch)
    return out


# ---------------------------------------------------------------------------
# phase 14: the front ends and the training path
# ---------------------------------------------------------------------------


def _rel_err(got, want) -> float:
    """max |got - want| over max |want| (float32)."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp(min=1e-30)).item()


def phase_flash_grad(torch, np):
    """[flash-grad]: the flash kernel's log-sum-exp output against the
    plain version's, ``FlashAttention``'s gradients (the kernel forward,
    the plain-torch backward) against autograd through the plain version,
    and the times: the forward with the LSE beside it without (the serve
    route), the plain backward beside SDPA's, at the two training
    shapes."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.models.attention import flash_attention_bwd
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 14)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for arch, b, s_len, h, hk, dh, windows in FLASH_GRAD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            q, k, v, dout = (torch.randn(shape, generator=gen, device=dev
                                         ).to(dtype)
                             for shape in ((b, s_len, h, dh),
                                           (b, s_len, hk, dh),
                                           (b, s_len, hk, dh),
                                           (b, s_len, h, dh)))
            for window in windows:
                label = (f"{arch} train B={b} S={s_len} H={h} Hk={hk} "
                         f"Dh={dh} causal window={window} {name}")
                o_k, lse_k = fa.flash_attention(q, k, v, causal=True,
                                                window=window,
                                                return_lse=True)
                torch.cuda.synchronize()
                o_r, lse_r = ref.flash_attention_ref(q, k, v, causal=True,
                                                     window=window,
                                                     return_lse=True)
                lse_err = (lse_k - lse_r).abs().max().item()
                torch.testing.assert_close(
                    lse_k, lse_r, atol=LSE_TOL[0], rtol=LSE_TOL[1],
                    msg=lambda m: f"flash-grad {label} lse: {m}")
                # gradients: FlashAttention (kernel forward with the LSE,
                # plain backward) against autograd through the plain one
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                launched = fa.flash_attention.launches
                got = torch.autograd.grad(
                    kops.flash_attention(*leaves, causal=True,
                                         window=window), leaves, dout)
                if fa.flash_attention.launches != launched + 1:
                    raise AssertionError(
                        f"flash-grad {label}: "
                        f"{fa.flash_attention.launches - launched} launches "
                        "for one forward and backward, want 1")
                want = torch.autograd.grad(
                    ref.flash_attention_ref(*leaves, causal=True,
                                            window=window), leaves, dout)
                errs = [_rel_err(g, w) for g, w in zip(got, want)]
                if not all(torch.isfinite(g.float()).all() for g in got) or \
                        max(errs) > FLASH_GRAD_TOL[name]:
                    raise AssertionError(
                        f"flash-grad {label}: dq, dk, dv relative errors "
                        f"{errs} (tol {FLASH_GRAD_TOL[name]:g})")
                # times: forward with / without the LSE, plain backward,
                # SDPA forward and backward on the same inputs.  The
                # forwards are timed behind a spin, so each span is the
                # device's work alone; a bf16 forward here is shorter than
                # the host's issue of one call, so without the spin a span
                # also holds the host's time between the start event and
                # the launch (timed as well, to show that difference)
                fwd = lambda: fa.flash_attention(q, k, v, causal=True,
                                                 window=window)
                fwd_lse = lambda: fa.flash_attention(
                    q, k, v, causal=True, window=window, return_lse=True)
                fwd_ms = time_ms(torch, fwd, 20, spin=GROUP_SPIN_CYCLES)
                lse_ms = time_ms(torch, fwd_lse, 20, spin=GROUP_SPIN_CYCLES)
                fwd_ms_issue = time_ms(torch, fwd, 20)
                lse_ms_issue = time_ms(torch, fwd_lse, 20)
                bwd_ms = time_ms(torch, lambda: flash_attention_bwd(
                    q, k, v, o_k, lse_k, dout, causal=True, window=window), 5)
                plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(
                    q, k, v, causal=True, window=window, return_lse=True), 3)
                qt, kt, vt = (x.detach().transpose(1, 2).contiguous()
                              .requires_grad_() for x in (q, k, v))
                if window:
                    i = torch.arange(s_len, device=dev)
                    band = (i[None] <= i[:, None]) & \
                        (i[None] > i[:, None] - window)
                    lib_fwd = lambda: sdpa(qt, kt, vt, attn_mask=band,
                                           enable_gqa=True)
                else:
                    lib_fwd = lambda: sdpa(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
                lib_ms = time_ms(torch, lib_fwd, 10, spin=GROUP_SPIN_CYCLES)
                o_lib = lib_fwd()
                dout_t = dout.transpose(1, 2).contiguous()
                lib_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
                    o_lib, (qt, kt, vt), dout_t, retain_graph=True), 5)
                esize = q.element_size()
                bound_ms, bound_by, flops = flash_bound(
                    s_len, s_len, True, window, h, hk, dh, esize, name)
                bound_ms *= b
                lse_bytes = b * h * s_len * 4
                bound_lse = max(bound_ms, (b * (2 * s_len * h * dh + 2 *
                                                s_len * hk * dh) * esize
                                           + lse_bytes) / HBM_BYTES_PER_S
                                * 1e3)
                # the backward: 5 products of 2 * Dh flops a live (query,
                # key) pair and head (s, dv, dp, dq, dk); q, k, v, out,
                # dout, lse read, dq, dk, dv written
                bwd_bound = max(2.5 * flops * b / PEAK_FLOPS["float32"],
                                (b * (6 * s_len * h * dh + 4 * s_len * hk *
                                      dh) * esize + lse_bytes)
                                / HBM_BYTES_PER_S) * 1e3
                log(f"[flash-grad] {label}: max |lse kernel - plain| = "
                    f"{lse_err:.3e} (atol {LSE_TOL[0]:g}, rtol "
                    f"{LSE_TOL[1]:g}); dq/dk/dv relative "
                    f"{errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} (tol "
                    f"{FLASH_GRAD_TOL[name]:g}) ok")
                log(f"[flash-grad] {label}: forward kernel_ms={fwd_ms:.4f} "
                    f"with lse {lse_ms:.4f} (bound {bound_lse:.4f}, "
                    f"{bound_by}) plain_ms={plain_ms:.4f} "
                    f"library_ms(sdpa fwd)={lib_ms:.4f}; backward "
                    f"plain-torch {bwd_ms:.4f} ms beside sdpa's "
                    f"{lib_bwd_ms:.4f} (bound {bwd_bound:.4f}, float32 "
                    f"arithmetic); forwards timed without the spin (the "
                    f"host's issue inside the span) {fwd_ms_issue:.4f}, "
                    f"with lse {lse_ms_issue:.4f}")
                out[f"{arch} window={window} {name}"] = {
                    "max_abs_err": (o_k.float() - o_r.float()).abs().max()
                    .item(), "lse_max_abs_err": lse_err,
                    "grad_rel_err": errs, "ms": lse_ms,
                    "ms_without_lse": fwd_ms, "ms_unspun": lse_ms_issue,
                    "ms_without_lse_unspun": fwd_ms_issue,
                    "plain_ms": plain_ms,
                    "bound_ms": bound_lse, "bound_by": bound_by,
                    "library_ms": lib_ms, "bwd_plain_ms": bwd_ms,
                    "bwd_library_ms": lib_bwd_ms, "bwd_bound_ms": bwd_bound}
                del o_lib, qt, kt, vt
    return out


def phase_scan_grad(torch, np):
    """[scan-grad]: ``RGLRUScan``'s da, db, dh0 (the forward and one
    reversed launch of the scan kernel) against autograd through the plain
    loop; the reversed launch's time beside its bytes bound."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rs
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 15)
    b, s_len, dr = SCAN_GRAD_SHAPE
    a = torch.sigmoid(torch.randn((b, s_len, dr), generator=gen, device=dev))
    bb = torch.randn((b, s_len, dr), generator=gen, device=dev)
    h0 = torch.randn((b, dr), generator=gen, device=dev)
    dh = torch.randn((b, s_len, dr), generator=gen, device=dev)
    leaves = [t.clone().requires_grad_() for t in (a, bb, h0)]
    launched = rs.rglru_scan.launches
    got = torch.autograd.grad(kops.rglru_scan(*leaves), leaves, dh)
    torch.cuda.synchronize()
    if rs.rglru_scan.launches != launched + 2:
        raise AssertionError(f"scan-grad: {rs.rglru_scan.launches - launched}"
                             " launches for a forward and backward, want 2")
    def plain_scan(a, b, h):
        """The plain loop, differentiable: each step a multiply, rounded,
        then an add, rounded, as ``ref.rglru_scan_ref`` steps."""
        hs = []
        for t in range(a.shape[1]):
            h = torch.add(torch.mul(a[:, t], h), b[:, t])
            hs.append(h)
        return torch.stack(hs, dim=1)

    want = torch.autograd.grad(plain_scan(*leaves), leaves, dh)
    errs = [_rel_err(g, w) for g, w in zip(got, want)]
    if max(errs) > SCAN_GRAD_TOL:
        raise AssertionError(f"scan-grad: da, db, dh0 relative errors {errs}"
                             f" (tol {SCAN_GRAD_TOL:g})")
    # the reversed launch alone, and the whole backward (the flips, the
    # launch and the products), cold L2
    a_rev = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1).flip(1)
    dh_rev = dh.flip(1).contiguous()
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = time_ms(torch, lambda: rs.rglru_scan(a_rev, dh_rev), 50,
                 flush_buf.zero_)
    hs = kops.rglru_scan(*leaves)
    bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        hs, leaves, dh, retain_graph=True), 20, flush_buf.zero_)
    plain_ms = time_ms(torch, lambda: ref.rglru_scan_ref(a_rev, dh_rev), 3,
                       flush_buf.zero_)
    bound_ms, bound_by = cost.least_ms(*cost.scan_cost(b, s_len, dr),
                                       "float32")
    log(f"[scan-grad] B={b} S={s_len} Dr={dr} float32: da/db/dh0 relative "
        f"{errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} (tol {SCAN_GRAD_TOL:g}) "
        f"ok; 2 launches a forward and backward; reversed launch "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f}"
        f" ({bound_by}); whole backward {bwd_ms:.4f} ms, cold L2")
    return {"grad_rel_err": errs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "backward_ms": bwd_ms, "max_abs_err": max(
                (g - w).abs().max().item() for g, w in zip(got, want))}


def _train_run(torch, tag, cfg, rt, ocfg, dcfg, steps, **kw):
    """``train_loop.train`` from fresh weights (seed 0, on the card) over
    the synthetic stream: step 1 eager, step 2 captured and replayed, the
    rest replays (gated: one capture, replays = steps - 1); returns
    (params, opt_state, result, launches, peak allocated GiB); the peak
    reserved GiB and the ms of the replayed steps go into
    ``result.graphs``."""
    from repro_torch.data.pipeline import batches
    from repro_torch.models import model as model_lib
    from repro_torch.training import train_loop
    held = _private_pools(torch)
    torch.cuda.reset_peak_memory_stats()
    params = kw.pop("params", None)
    if params is None:
        params = model_lib.init_params(cfg, SEED, rt, "cuda")
    data = kw.pop("data", None) or batches(dcfg)
    reset_counts()
    params, opt, res = train_loop.train(cfg, rt, ocfg, data, steps=steps,
                                        params=params, **kw)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.max_memory_reserved() / 2 ** 30
    st = res.graphs
    if st["eager_by_kind"] != {"train": 1} or st["captures"] != 1 or \
            st["replays"] != steps - 1:
        raise AssertionError(f"{tag}: graph books {st}, want step 1 eager, "
                             f"one capture and {steps - 1} replays")
    secs = res.step_seconds
    replay_ms = sorted(secs[2:])[len(secs[2:]) // 2] * 1e3 \
        if steps > 2 else float("nan")
    st.update(peak_reserved_gib=reserved, replay_ms=replay_ms,
              step1_ms=secs[0] * 1e3,
              step2_ms=secs[1] * 1e3 if steps > 1 else float("nan"),
              graph_pools_before=held)
    log(f"[{tag}] {steps} steps: loss {res.losses[0]:.4f} -> "
        f"{res.losses[-1]:.4f}; {res.tokens_per_second:.1f} tok/s, "
        f"{res.seconds / steps * 1e3:.1f} ms a step (step 1 eager "
        f"{st['step1_ms']:.1f}, step 2 captured and replayed "
        f"{st['step2_ms']:.1f}, replays median {replay_ms:.1f}; capture "
        f"{st['capture_s']:.2f} s, {st['instantiate_s']:.2f} instantiating)"
        f"; peak {peak:.2f} GiB allocated, {reserved:.2f} reserved (graph "
        f"pools held at the start {held['reserved_gib']:.3f}); launches "
        f"{counts}")
    return params, opt, res, counts, peak


def _private_pools(torch) -> dict:
    """GiB reserved and allocated in the card's private (graph) pools,
    after a collection and an empty cache: what a graphed run leaves."""
    _free_card(torch)
    reserved = allocated = 0
    for seg in torch.cuda.memory_snapshot():
        if tuple(seg.get("segment_pool_id", (0, 0))) == (0, 0):
            continue
        reserved += seg["total_size"]
        allocated += seg["allocated_size"]
    return {"reserved_gib": reserved / 2 ** 30,
            "allocated_gib": allocated / 2 ** 30}


def _eager_train(torch, tag, cfg, rt, ocfg, dcfg, steps) -> dict:
    """``make_train_step`` (the functional step, the eager form: new
    weights and moments each step) applied ``steps`` times from fresh
    weights (seed 0) over the synthetic stream, as the graphed run starts.
    Returns the losses, ms a step (the median after the first), peak
    allocated and reserved GiB."""
    from repro_torch.data.pipeline import batches
    from repro_torch.models import model as model_lib
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_loop
    _free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init_params(cfg, SEED, rt, "cuda")
    opt = opt_lib.init(ocfg, params)
    step = train_loop.make_train_step(cfg, rt, ocfg)
    data, losses, secs = batches(dcfg), [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, next(data))
        losses.append(float(met["loss"]))
        secs.append(time.perf_counter() - t0)
    del params, opt, met
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved = torch.cuda.max_memory_reserved() / 2 ** 30
    ms = sorted(secs[1:])[len(secs[1:]) // 2] * 1e3
    log(f"[{tag}] eager (make_train_step, functional update) {steps} steps "
        f"from the same weights and batches: {ms:.1f} ms a step (median "
        f"after the first), peak {peak:.2f} GiB allocated, {reserved:.2f} "
        "reserved")
    return {"losses": losses, "ms_per_step": ms, "peak_gib": peak,
            "peak_reserved_gib": reserved}


def _same_losses(torch, tag, eager: dict, graphed) -> None:
    """Gate: the eager run's losses equal the graphed run's first steps
    within ``TRAIN_RESUME_TOL`` relative (the CUDA embedding backward
    accumulates with atomics); logs how many are bit-equal and what the
    graphed run left in the graph pools."""
    steps = len(eager["losses"])
    want = graphed.losses[:steps]
    rel = max(abs(a - b) / abs(b) for a, b in zip(eager["losses"], want))
    if rel > TRAIN_RESUME_TOL:
        raise AssertionError(f"{tag}: eager losses {eager['losses']} "
                             f"against the graphed run's {want}: {rel:.2e} "
                             "relative")
    same = sum(a == b for a, b in zip(eager["losses"], want))
    left = _private_pools(torch)
    eager.update(max_rel_loss_diff=rel, bit_equal_losses=same,
                 graph_pools_after=left)
    log(f"[{tag}] the graphed run's first {steps} losses within {rel:.2e} "
        f"relative of the eager run's (tol {TRAIN_RESUME_TOL:g}), {same} "
        f"of {steps} bit-equal; replays {graphed.graphs['replay_ms']:.1f} "
        f"ms a step against eager {eager['ms_per_step']:.1f}; left in the "
        f"graph pools after the run: {left['reserved_gib']:.3f} GiB "
        f"reserved, {left['allocated_gib']:.3f} allocated")


def _falls(tag, losses, n):
    """The mean of the last ``n`` losses below the first ``n``'s, all
    finite."""
    first, last = sum(losses[:n]) / n, sum(losses[-n:]) / n
    if not all(math.isfinite(x) for x in losses) or not last < first:
        raise AssertionError(f"{tag}: the loss did not fall (first {n} "
                             f"mean {first:.4f}, last {last:.4f}): {losses}")
    return first, last


def phase_train_gemma(torch, np, card: str):
    """[train-gemma3-1b]: full-width, full-depth gemma3-1b trained as the
    CLI trains it; then a checkpointed run resumed by a fresh manager; then
    an int8-compressed run."""
    import shutil

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import batches
    from repro_torch.distributed.compression import Compressor
    from repro_torch.launch import train as train_cli
    from repro_torch.models import model as model_lib
    from repro_torch.training import optimizer as opt_lib

    def cli(steps, *extra):
        return train_cli.setup(train_cli.parse_args(
            ["--arch", "gemma3-1b", "--full-size", "--steps", str(steps),
             "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
             "--seed", str(SEED), "--device", "cuda", *extra]))[1:]

    cfg, rt, ocfg, dcfg = cli(TRAIN_STEPS)
    log(f"[train-gemma3-1b] gemma3-1b full width and depth: "
        f"{cfg.num_layers} layers, vocab {cfg.vocab_size}, "
        f"{cfg.param_count() / 1e9:.3f}B params float32, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, AdamW lr {ocfg.lr:g} (warmup "
        f"{ocfg.warmup_steps}, cosine over {ocfg.total_steps}), on {card}")
    eager = _eager_train(torch, "train-gemma3-1b", cfg, rt, ocfg, dcfg,
                         TRAIN_EAGER_STEPS)
    _, _, res, counts, peak = _train_run(torch, "train-gemma3-1b", cfg, rt,
                                         ocfg, dcfg, TRAIN_STEPS)
    _same_losses(torch, "train-gemma3-1b", eager, res)
    first, last = _falls("train-gemma3-1b", res.losses, 5)
    want = TRAIN_STEPS * cfg.num_layers
    if counts != {"paged_attention": 0, "flash_attention": want,
                  "rglru_scan": 0, "chunk_attention": 0}:
        raise AssertionError(f"train-gemma3-1b: launches {counts}, want "
                             f"{want} flash (steps x layers)")
    summary = {"steps": TRAIN_STEPS, "losses": res.losses,
               "first5": first, "last5": last,
               "tok_per_s": res.tokens_per_second,
               "ms_per_step": res.seconds / TRAIN_STEPS * 1e3,
               "peak_gib": peak, "flash_launches": counts["flash_attention"],
               "graphs": res.graphs, "eager": eager}
    paths = {"gemma3-1b train": counts}

    # crash and resume: 20 steps with a checkpoint every 10; a fresh
    # manager restores step 10 onto a fresh template, the stream replays
    # its first 10 batches, and steps 11-20 must give the same losses
    cfg, rt, ocfg, dcfg = cli(TRAIN_RESUME_STEPS)
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    mgr = CheckpointManager(str(TRAIN_CKPT_DIR), keep=3)
    t0 = time.perf_counter()
    _, _, ref_run, c_ref, _ = _train_run(
        torch, "train-gemma3-1b resume-ref", cfg, rt, ocfg, dcfg,
        TRAIN_RESUME_STEPS, checkpoint_mgr=mgr,
        checkpoint_every=TRAIN_CKPT_EVERY)
    wall_ref = time.perf_counter() - t0
    _free_card(torch)
    fresh = CheckpointManager(str(TRAIN_CKPT_DIR), keep=3)
    t0 = time.perf_counter()
    template = model_lib.init_params(cfg, SEED + 1, rt, "cuda")
    restored, _ = fresh.restore({"params": template,
                                 "opt_state": opt_lib.init(ocfg, template)},
                                step=TRAIN_CKPT_EVERY)
    del template
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if int(restored["opt_state"].step) != TRAIN_CKPT_EVERY:
        raise AssertionError("train-gemma3-1b: restored step "
                             f"{int(restored['opt_state'].step)}")
    data = batches(dcfg)
    for _ in range(TRAIN_CKPT_EVERY):
        next(data)
    _, _, resumed, c_res, _ = _train_run(
        torch, "train-gemma3-1b resumed", cfg, rt, ocfg, dcfg,
        TRAIN_RESUME_STEPS - TRAIN_CKPT_EVERY, params=restored["params"],
        opt_state=restored["opt_state"], data=data)
    del restored
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    tail = ref_run.losses[TRAIN_CKPT_EVERY:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed.losses, tail))
    if rel > TRAIN_RESUME_TOL:
        raise AssertionError(f"train-gemma3-1b: resumed losses "
                             f"{resumed.losses} differ from the uninterrupted "
                             f"run's {tail} by {rel:.2e} relative")
    log(f"[train-gemma3-1b] crash and resume: steps "
        f"{TRAIN_CKPT_EVERY + 1}-{TRAIN_RESUME_STEPS} resumed from the step "
        f"{TRAIN_CKPT_EVERY} checkpoint within {rel:.2e} relative of the "
        f"uninterrupted run's (tol {TRAIN_RESUME_TOL:g}); the checkpointed "
        f"run took {wall_ref:.1f}s with {TRAIN_RESUME_STEPS // TRAIN_CKPT_EVERY}"
        f" saves, the restore {restore_s:.1f}s")
    summary["resume"] = {"max_rel_loss_diff": rel, "losses_ref": tail,
                         "losses_resumed": resumed.losses,
                         "checkpointed_run_s": wall_ref,
                         "restore_s": restore_s}
    paths["gemma3-1b train resume"] = {
        k: c_ref[k] + c_res[k] for k in c_ref}

    # int8-compressed gradients
    cfg, rt, ocfg, dcfg = cli(TRAIN_COMPRESS_STEPS, "--compress", "int8")
    comp = Compressor(method="int8")
    params, _, res_c, c_comp, _ = _train_run(
        torch, "train-gemma3-1b int8", cfg, rt, ocfg, dcfg,
        TRAIN_COMPRESS_STEPS, compressor=comp)
    c_first, c_last = _falls("train-gemma3-1b int8", res_c.losses, 5)
    ratio = comp.compression_ratio(params)
    log(f"[train-gemma3-1b] int8 gradients: loss {c_first:.4f} -> "
        f"{c_last:.4f} (mean of the first / last 5), compression_ratio "
        f"{ratio:.3f}, {comp.wire_bytes(params) / 2 ** 30:.3f} GiB a round "
        "on the wire")
    summary["int8"] = {"losses": res_c.losses, "compression_ratio": ratio,
                       "tok_per_s": res_c.tokens_per_second}
    paths["gemma3-1b train int8"] = c_comp
    del params
    return paths, summary


def phase_train_rgemma(torch, np, card: str):
    """[train-rgemma]: recurrentgemma-9b at full width, its first 3 layers,
    trained as the CLI trains: the scan kernel forward and reversed in each
    rglru layer, the flash kernel in the local one."""
    import dataclasses

    from repro_torch.launch import train as train_cli
    args = train_cli.parse_args(
        ["--arch", "recurrentgemma-9b", "--full-size", "--steps",
         str(RG_TRAIN_STEPS), "--batch", str(RG_TRAIN_BATCH), "--seq",
         str(RG_TRAIN_SEQ), "--seed", str(SEED), "--device", "cuda"])
    _, cfg, rt, ocfg, dcfg = train_cli.setup(args)
    cfg = dataclasses.replace(cfg, num_layers=RG_TRAIN_LAYERS)
    kinds = cfg.layer_kinds()
    log(f"[train-rgemma] recurrentgemma-9b full width, layers {kinds}, "
        f"{cfg.param_count() / 1e9:.3f}B params float32, batch "
        f"{RG_TRAIN_BATCH} x {RG_TRAIN_SEQ}, on {card}")
    eager = _eager_train(torch, "train-rgemma", cfg, rt, ocfg, dcfg,
                         TRAIN_EAGER_STEPS)
    _, _, res, counts, peak = _train_run(torch, "train-rgemma", cfg, rt,
                                         ocfg, dcfg, RG_TRAIN_STEPS)
    _same_losses(torch, "train-rgemma", eager, res)
    first, last = _falls("train-rgemma", res.losses, 3)
    n_rg = kinds.count("rglru")
    want = {"paged_attention": 0,
            "flash_attention": RG_TRAIN_STEPS * (len(kinds) - n_rg),
            "rglru_scan": RG_TRAIN_STEPS * n_rg * 2, "chunk_attention": 0}
    if counts != want:
        raise AssertionError(f"train-rgemma: launches {counts}, want {want}"
                             " (scan: steps x rglru layers x forward and "
                             "reversed)")
    return {"recurrentgemma-9b train": counts}, {
        "losses": res.losses, "first3": first, "last3": last,
        "tok_per_s": res.tokens_per_second,
        "ms_per_step": res.seconds / RG_TRAIN_STEPS * 1e3, "peak_gib": peak,
        "graphs": res.graphs, "eager": eager}


def phase_frontend_serve(torch, np, card: str, arch: str, tag: str):
    """[frontend-musicgen] / [frontend-qwen2vl]: the arch at full width and
    depth in bf16 through ``LLM.generate`` with the yi-9b phase's traffic
    (token ids inside the arch's vocab); paged launches ticks x layers."""
    from repro_torch.config import get_arch
    from repro_torch.models import model as model_lib
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import EngineConfig
    _free_card(torch)
    cfg = get_arch(arch)
    rt = _arch_rt(torch, torch.bfloat16)
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, SEED, rt, "cuda")
    torch.cuda.synchronize()
    g = cfg.num_heads // cfg.num_kv_heads
    log(f"[{tag}] {arch} full width and depth: {cfg.num_layers} layers, "
        f"{cfg.num_heads} heads over {cfg.num_kv_heads} (G = {g}) of "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}, frontend {cfg.frontend}; "
        f"{_param_bytes(params) / 1e9:.2f} GB of bf16 weights from seed "
        f"{SEED} in {time.perf_counter() - t0:.1f}s")
    econf = EngineConfig(
        mb_size=SERVE_MB, num_microbatches=SERVE_N_MB,
        pool=PoolConfig(page_size=SERVE_PAGE, n_local_pages=SERVE_POOL_PAGES,
                        max_pages_per_seq=SERVE_MAX_PAGES),
        seed=SEED, max_prefill_tokens_per_tick=256)
    torch.cuda.reset_peak_memory_stats()
    llm, outs, counts, rep, wall = _arch_serve(
        torch, np, tag, cfg, params, rt, econf, SERVE_REQUESTS,
        SERVE_PROMPTS, SERVE_NEW)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ticks = rep["decode_ticks"]
    if counts != {"paged_attention": ticks * cfg.num_layers,
                  "flash_attention": 0, "rglru_scan": 0,
                  "chunk_attention": chunk_launches(llm.engine.backend,
                                                    cfg)}:
        raise AssertionError(f"{tag}: launches {counts} for {ticks} ticks x "
                             f"{cfg.num_layers} layers")
    log(f"[{tag}] on {card}: {len(outs)}/{SERVE_REQUESTS} requests; decode "
        f"{rep['decode_tok_per_s']:.1f} tok/s, prefill "
        f"{rep['prefill_tok_per_s']:.1f} tok/s; paged launches "
        f"{counts['paged_attention']} (= {ticks} ticks x {cfg.num_layers}, "
        f"G = {g} at Dh = {cfg.head_dim}); peak {peak:.2f} GiB")
    del llm, params
    return {f"{arch}": counts}, {
        "decode_tok_per_s": rep["decode_tok_per_s"],
        "prefill_tok_per_s": rep["prefill_tok_per_s"], "peak_gib": peak,
        "decode_ticks": ticks, "wall_s": wall, "requests": len(outs)}


def _paged_from_dense(torch, np, cfg, rt, dense, b: int, cap: int, dev):
    """Paged caches (the serve phase's page size) that hold what a prefill
    wrote into dense caches of ``cap`` slots: row r's slot i at page
    ``table[r, i // page]``, offset ``i % page``.  A front-end prefill
    cannot write the pools itself: ``prefill_chunk`` takes tokens only,
    and on a vision arch the cache slot is the token's index while its t
    position repeats (every patch sits at t = 0)."""
    from repro_torch.serving import kv_cache as kvc
    per_row = -(-cap // SERVE_PAGE)
    pool = kvc.PoolConfig(page_size=SERVE_PAGE,
                          n_local_pages=b * per_row + 1,
                          max_pages_per_seq=per_row)
    table = 1 + np.arange(b * per_row, dtype=np.int32).reshape(b, per_row)
    caches = kvc.set_page_table(kvc.build_paged_caches(cfg, b, pool, rt, dev),
                                table)
    rows = torch.from_numpy(table).long().to(dev)
    for src, dst in zip(dense["layers"], caches["layers"]):
        for name in ("k", "v"):
            t = torch.nn.functional.pad(
                src[name], (0, 0, 0, 0, 0, per_row * SERVE_PAGE - cap))
            dst[f"{name}_pages"][rows] = t.reshape(
                b, per_row, SERVE_PAGE, *t.shape[2:])
    return caches


def phase_frontend_parity(torch, np):
    """[frontend-parity]: musicgen-large and qwen2-vl-2b at full width and
    FE_PARITY_LAYERS layers, float32, on the CPU and on the card: a prefill
    of audio frames, or of text after 256 vision patches (the flash kernel
    at G = 1, Dh = 64 and at G = 6 padded to 8), then greedy decode steps
    (qwen2-vl from S + P, as the JAX package's test decodes).  The CPU
    decodes from dense caches (the path the CPU tests hold to the JAX
    package) and from paged pools (the paged kernel's plain version); the
    card from paged pools, so each decode step runs the paged kernel at the
    served head geometry, fed the CPU's greedy tokens.  The card's logits
    within FE_PARITY_TOL of both CPU runs, the greedy tokens equal, and
    the paged kernel launched steps x layers times."""
    import dataclasses

    from repro_torch.config import get_arch
    from repro_torch.models import model as model_lib
    rt = _arch_rt(torch, torch.float32)
    rng = np.random.RandomState(SEED + 16)
    out = {}
    for arch in ("musicgen-large", "qwen2-vl-2b"):
        _free_card(torch)
        cfg = dataclasses.replace(get_arch(arch), num_layers=FE_PARITY_LAYERS)
        cpu_params = model_lib.init_params(cfg, SEED, rt, "cpu")
        card_params = _to(cpu_params, "cuda")
        b, s_len = 2, FE_PARITY_S
        if cfg.frontend == "audio_frames":
            inputs = {"frames": rng.randn(b, s_len, cfg.d_model)
                      .astype(np.float32)}
            start = s_len
        else:
            p = cfg.num_patch_tokens
            inputs = {"tokens": rng.randint(1, cfg.vocab_size, (b, s_len))
                      .astype(np.int64),
                      "patches": (0.1 * rng.randn(b, p, cfg.d_model))
                      .astype(np.float32)}
            start = s_len + p
        cap = start + FE_PARITY_STEPS + 1
        # the dense CPU run decodes its own greedy tokens; the other two
        # are fed those, so one differing argmax does not change every
        # later input
        logits, counts = {}, None
        for run, dev, params in (("cpu dense", "cpu", cpu_params),
                                 ("cpu paged", "cpu", cpu_params),
                                 ("card paged", "cuda", card_params)):
            x = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
            with torch.inference_mode():
                lg, caches = model_lib.prefill(params, x, cfg, rt, cap)
                if run != "cpu dense":
                    caches = _paged_from_dense(torch, np, cfg, rt, caches, b,
                                               cap, dev)
                steps = [lg]
                if dev == "cuda":
                    torch.cuda.synchronize()
                    reset_counts()
                for i in range(FE_PARITY_STEPS):
                    feed = steps[-1].argmax(-1) if run == "cpu dense" else \
                        logits["cpu dense"][i].argmax(-1).to(dev)
                    cur = torch.full((b,), start + i, dtype=torch.int64,
                                     device=dev)
                    lg, caches = model_lib.decode_step(params, feed, caches,
                                                       cur, cfg, rt)
                    steps.append(lg)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    counts = read_counts()
            logits[run] = torch.stack(steps).cpu()
        want_counts = {"paged_attention": FE_PARITY_STEPS * FE_PARITY_LAYERS,
                       "flash_attention": 0, "rglru_scan": 0,
                       "chunk_attention": 0}
        if counts != want_counts:
            raise AssertionError(f"frontend-parity {arch}: card decode "
                                 f"launches {counts}, want {want_counts}")
        card = logits["card paged"]
        err = (card - logits["cpu dense"]).abs().max().item()
        err_plain = (card - logits["cpu paged"]).abs().max().item()
        scale = logits["cpu dense"].abs().max().item()
        same = bool((card.argmax(-1) ==
                     logits["cpu dense"].argmax(-1)).all())
        g = cfg.num_heads // cfg.num_kv_heads
        log(f"[frontend-parity] {arch} {FE_PARITY_LAYERS} layers full width "
            f"float32, {'frames' if 'frames' in inputs else 'tokens + patches'}"
            f" prefill then {FE_PARITY_STEPS} paged decode steps from {start} "
            f"(paged kernel {counts['paged_attention']} launches at G = {g}, "
            f"Dh = {cfg.head_dim}): max |card paged - cpu dense| logits "
            f"{err:.3e}, |card paged - cpu paged (plain kernel)| "
            f"{err_plain:.3e} (max |logit| {scale:.2f}, tol "
            f"{FE_PARITY_TOL:g}); greedy tokens equal: {same}")
        if err > FE_PARITY_TOL or err_plain > FE_PARITY_TOL or not same:
            raise AssertionError(f"frontend-parity {arch}: logits {err:.3e} "
                                 f"/ {err_plain:.3e} apart, greedy equal "
                                 f"{same}")
        out[arch] = {"max_abs_logit_err": err,
                     "max_abs_logit_err_vs_paged_plain": err_plain,
                     "max_abs_logit": scale, "greedy_equal": same,
                     "paged_launches": counts["paged_attention"]}
        del cpu_params, card_params
    return out


def phase_frontends_and_training(torch, np, card: str):
    """Phase 14; returns (launch counts by path, the ``train`` summary)."""
    summary = {"flash_grad": phase_flash_grad(torch, np),
               "scan_grad": phase_scan_grad(torch, np)}
    paths, summary["gemma3-1b"] = phase_train_gemma(torch, np, card)
    rg_counts, summary["recurrentgemma-9b"] = phase_train_rgemma(torch, np,
                                                                 card)
    paths.update(rg_counts)
    for arch, tag in (("musicgen-large", "frontend-musicgen"),
                      ("qwen2-vl-2b", "frontend-qwen2vl")):
        fe_counts, summary[arch] = phase_frontend_serve(torch, np, card,
                                                        arch, tag)
        paths.update(fe_counts)
    summary["frontend_parity"] = phase_frontend_parity(torch, np)
    return paths, summary


# ---------------------------------------------------------------------------
# phase 15: the fixed-batch pipeline passes, the §6 market, the examples
# ---------------------------------------------------------------------------


def _clone_tree(tree):
    """A copy of a cache tree (dicts, lists, None, tensors)."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return None if tree is None else tree.clone()


def _cache_leaves(caches) -> list:
    """Every tensor of a cache tree, in a fixed order."""
    if isinstance(caches, dict):
        return [t for k in sorted(caches) for t in _cache_leaves(caches[k])]
    if isinstance(caches, list):
        return [t for c in caches for t in _cache_leaves(c)]
    return [] if caches is None else [caches]


def _put_tree(dst, src) -> None:
    """Copy a cache tree's values into another of its shape, in place."""
    for a, b in zip(_cache_leaves(dst), _cache_leaves(src)):
        a.copy_(b)


def _tree_gap(torch, got, want) -> float:
    """Largest |difference| between two cache trees' leaves (0.0 when
    equal; positions and ints compared as floats)."""
    gap = 0.0
    for a, b in zip(_cache_leaves(got), _cache_leaves(want)):
        if not torch.equal(a, b):
            gap = max(gap, (a.float() - b.float()).abs().max().item())
    return gap


def _fixed_run(torch, cfg, rt, params, pcfg, inputs, cap, rounds, dev):
    """The three fixed-batch passes on ``inputs`` (B, S) tokens through
    ``core.pipeline.FixedPasses`` (on the card every stage call, head and
    drain a replayed CUDA graph), beside the functional passes (the eager
    form) on caches of their own and two runs of the plain model on the
    same weights and tokens:

    - ``mb``: a microbatch at a time (``model.prefill`` and ``decode_step``
      on its ``mb_size`` rows and caches of its own), so every layer sees
      the rows the pipeline's stage calls see;
    - ``batch``: the whole batch in one call.

    Each gives a prefill, a decode step of the pipe's greedy tokens (the
    holder's caches put back after it, the functional step on a copy) and
    ``rounds`` greedy rounds (sequential greedy decode steps for the plain
    model).  The holder's first prefill captures its prefill keys (after
    it ``reset`` clears the states it stepped), its decode step the decode
    keys and the head, a one-round pass the drains (caches put back), so
    the timed prefill and rounds are replays (launch counts of those two
    on ``cuda``).  ``graph_parity`` holds each replayed kind against the
    functional passes: logits, tokens and every cache leaf.  Returns (the
    numbers, the prefill's launch counts, the rounds')."""
    from repro_torch.core import pipeline as PL
    from repro_torch.models import model as model_lib
    from repro_torch.serving.sampler import greedy

    on_card = dev == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def clock(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    n_mb, mb, B = pcfg.n_microbatches, pcfg.mb_size, pcfg.global_batch
    S = inputs.shape[1]
    cur = torch.full((B,), S, dtype=torch.int32, device=dev)
    cur2 = cur.reshape(n_mb, mb)

    def plain(rows):
        """The plain model on ``rows``: prefill logits, caches, seconds."""
        (lg, c), t = clock(lambda: model_lib.prefill(
            params, {"tokens": inputs[rows]}, cfg, rt, cap))
        return lg, c, t

    def plain_decodes(rows, tok, caches):
        """A decode step's logits (on a copy of ``caches``), then
        ``rounds`` sequential greedy steps: (step, (rounds, rows) tokens,
        seconds)."""
        step, _ = model_lib.decode_step(params, tok, _clone_tree(caches),
                                        cur[rows], cfg, rt)

        def steps():
            seq, t, c = [], tok, caches
            for r in range(rounds):
                lg, c = model_lib.decode_step(params, t, c, cur[rows] + r,
                                              cfg, rt)
                t = greedy(lg)
                seq.append(t)
            return torch.stack(seq)
        seq, secs = clock(steps)
        return step, seq, secs

    def parity(kind, got, want, got_c, want_c):
        exact = torch.equal(got, want)
        gap = _tree_gap(torch, got_c, want_c)
        return {"kind": kind, "equal": exact,
                "max_abs_err": 0.0 if exact else
                (got.float() - want.float()).abs().max().item(),
                "cache_gap": gap}

    queue = inputs.reshape(n_mb, mb, S)
    fp = PL.FixedPasses(params, cfg, rt, pcfg, cap, device=dev)
    # the first prefill captures the prefill keys; a prefill starts the
    # recurrent layers from the states it finds, so reset before the next
    _, capture_prefill_s = clock(lambda: fp.prefill(queue))
    fp.reset()
    if on_card:
        reset_counts()
    logits, prefill_s = clock(lambda: fp.prefill(queue))
    prefill_counts = read_counts() if on_card else None
    eager_c = PL.init_pipeline_caches(cfg, pcfg, cap, rt, device=dev)
    (e_logits, eager_c), eager_prefill_s = clock(
        lambda: PL.pipeline_prefill(params, queue, eager_c, cfg, rt, pcfg))
    checks = [parity("prefill stages, embed, head", logits, e_logits,
                     fp.caches, eager_c)]
    tok0 = greedy(logits.reshape(B, -1)).reshape(n_mb, mb)
    saved = _clone_tree(fp.caches)
    step = fp.decode_step(tok0, cur2)
    e_step, e_step_c = PL.pipeline_decode_step(
        params, tok0, _clone_tree(eager_c), cur2, cfg, rt, pcfg)
    checks.append(parity("decode stages, head", step, e_step, fp.caches,
                         e_step_c))
    del e_step_c
    _put_tree(fp.caches, saved)
    fp.decode_rounds(tok0, cur2, rounds=1)          # captures the drains
    _put_tree(fp.caches, saved)
    del saved
    if on_card:
        reset_counts()
    outs, rounds_s = clock(lambda: fp.decode_rounds(tok0, cur2,
                                                    rounds=rounds))
    rounds_counts = read_counts() if on_card else None
    (e_outs, eager_c), eager_rounds_s = clock(
        lambda: PL.pipeline_decode_rounds(params, tok0, eager_c, cur2, cfg,
                                          rt, pcfg, rounds=rounds))
    checks.append(parity("rounds: decode stages, drains", outs, e_outs,
                         fp.caches, eager_c))
    del eager_c
    run = {"logits": logits.reshape(B, -1), "step": step.reshape(B, -1),
           "rounds": outs.reshape(rounds, B), "prefill_s": prefill_s,
           "rounds_s": rounds_s, "eager_prefill_s": eager_prefill_s,
           "eager_rounds_s": eager_rounds_s,
           "capture_prefill_s": capture_prefill_s,
           "graph_parity": checks, "graphs": fp.graphs.stats()}
    del fp

    # the plain model, a microbatch at a time
    parts = []
    tok0 = tok0.reshape(B)
    for m in range(n_mb):
        rows = slice(m * mb, (m + 1) * mb)
        lg, c, t = plain(rows)
        parts.append((lg, t) + plain_decodes(rows, tok0[rows], c))
        del c
    run["mb"] = {"logits": torch.cat([p[0] for p in parts]),
                 "prefill_s": sum(p[1] for p in parts),
                 "step": torch.cat([p[2] for p in parts]),
                 "rounds": torch.cat([p[3] for p in parts], dim=1),
                 "seq_s": sum(p[4] for p in parts)}
    # the plain model over the whole batch at once
    lg, c, t = plain(slice(0, B))
    step_b, seq_b, secs_b = plain_decodes(slice(0, B), tok0, c)
    del c
    run["batch"] = {"logits": lg, "prefill_s": t, "step": step_b,
                    "rounds": seq_b, "seq_s": secs_b}
    for part in (run, run["mb"], run["batch"]):
        for name in ("logits", "step", "rounds"):
            part[name] = part[name].float().cpu() if name != "rounds" \
                else part[name].cpu()
    return run, prefill_counts, rounds_counts


def _fixed_graphs(tag, run, pcfg, rounds, card) -> dict:
    """Gate and log the holder's graph books after ``_fixed_run`` on the
    card: each replayed kind bit-equal to the functional passes (caches
    within ``GRAPH_CACHE_ATOL``, cuBLAS rounding under capture), one
    capture a key, and replays equal to the calls of each kind (two
    prefills; a decode step, a one-round and an R-round pass)."""
    for c in run["graph_parity"]:
        if not c["equal"] or c["cache_gap"] > GRAPH_CACHE_ATOL:
            raise AssertionError(f"{tag}: replayed {c['kind']} against the "
                                 f"functional pass: {c}")
        log(f"[graph-parity] {tag} {c['kind']}: replayed == eager "
            f"(functional pass on its own caches) bit for bit, cache gap "
            f"{c['cache_gap']:.3e} (tol {GRAPH_CACHE_ATOL:g})")
    st = run["graphs"]
    n_s, n_mb = pcfg.n_stages, pcfg.n_microbatches
    stage_calls = n_s * n_mb
    want_caps = {"fixed-embed": 1, "fixed-prefill": stage_calls,
                 "fixed-prefill-head": 1, "fixed-decode": stage_calls,
                 "fixed-decode-head": 1, "fixed-drain": n_mb}
    want_reps = {"fixed-embed": 2, "fixed-prefill": 2 * stage_calls,
                 "fixed-prefill-head": 2,
                 "fixed-decode": (2 + rounds) * stage_calls,
                 "fixed-decode-head": 1, "fixed-drain": (1 + rounds) * n_mb}
    if st["captures_by_kind"] != want_caps or st["keys"] != \
            st["captures"] or st["replays_by_kind"] != want_reps or \
            st["eager_by_kind"]:
        raise AssertionError(f"{tag}: graph books {st}, want captures "
                             f"{want_caps} (one a key), replays {want_reps}")
    log(f"[graphs] {tag} on {card}: {st['captures']} keys captured once "
        f"each in {st['capture_s']:.2f} s ({st['instantiate_s']:.2f} "
        f"instantiating; by kind "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    st["capture_s_by_kind"].items())
        + f"); {st['replays']} replays = every stage call, head and drain "
        f"from its capture on ({st['replays_by_kind']}); the first prefill "
        f"(warm-ups and captures) {run['capture_prefill_s'] * 1e3:.1f} ms")
    GRAPH_BOOKS[tag] = st
    return st


def _fixed_check(tag, run, bound_rel, card, pcfg, rounds, tokens):
    """Gate: the passes' greedy prefill, step and rounds tokens equal the
    plain model's run a microbatch at a time (the layers see the rows the
    stage calls see), and their prefill and step logits lie within
    ``bound_rel`` of the largest |logit|.  Reported beside it, not gated:
    the plain model over the whole batch in one call, whose GEMMs take
    other shapes, so its bf16 sums may round the other way and a near-tie
    go the other way (on an H100 at 700 W, yi-9b's decode step flipped 3
    of 16 greedy tokens at a logit difference of 2% of the largest).
    Logs and returns the numbers."""
    ref, whole = run["mb"], run["batch"]
    out = {}
    for name in ("logits", "step"):
        got, want = run[name], ref[name]
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        same = bool((got.argmax(-1) == want.argmax(-1)).all())
        if not same or err > bound_rel * scale:
            raise AssertionError(
                f"{tag}: {name} greedy tokens equal {same}, max |logit "
                f"difference| {err:.3e} against the bound {bound_rel:g} x "
                f"{scale:.3e}")
        key = "prefill" if name == "logits" else "step"
        out[key] = {
            "max_abs_logit_err": err, "max_abs_logit": scale,
            "bound": bound_rel * scale,
            "whole_batch_max_abs_logit_err":
                (got - whole[name]).abs().max().item(),
            "whole_batch_greedy_equal": int(
                (got.argmax(-1) == whole[name].argmax(-1)).sum()),
            "rows": got.shape[0]}
    # round r's token is the plain model's greedy token after r + 1 decode
    # steps (tests/test_pipeline_spmd.py holds got[:R-1] to its ref[1:],
    # whose ref[0] is the first input; here every round is held)
    got = run["rounds"]
    if not bool((got == ref["rounds"]).all()):
        bad = (got != ref["rounds"]).nonzero()[:4].tolist()
        raise AssertionError(f"{tag}: rounds differ from the sequential "
                             f"plain decodes at (round, row) {bad}")
    B = pcfg.global_batch
    n_s, n_mb = pcfg.n_stages, pcfg.n_microbatches
    bubble = (n_s - 1) / (rounds * n_mb + n_s - 1)
    agree = (got == whole["rounds"]).float().mean().item()
    out.update(
        prefill_ms=run["prefill_s"] * 1e3,
        eager_prefill_ms=run["eager_prefill_s"] * 1e3,
        plain_prefill_ms=whole["prefill_s"] * 1e3,
        plain_mb_prefill_ms=ref["prefill_s"] * 1e3,
        prefill_tok_per_s=B * tokens / run["prefill_s"],
        rounds_tok_per_s=rounds * B / run["rounds_s"],
        eager_rounds_tok_per_s=rounds * B / run["eager_rounds_s"],
        sequential_tok_per_s=rounds * B / whole["seq_s"],
        sequential_mb_tok_per_s=rounds * B / ref["seq_s"],
        whole_batch_rounds_share_equal=agree,
        bubble_share=bubble, rounds=rounds, rows=B)
    log(f"[{tag}] greedy prefill, step and {rounds}-round tokens equal the "
        f"plain model's run a microbatch at a time; max |logit difference| "
        f"prefill {out['prefill']['max_abs_logit_err']:.3e}, step "
        f"{out['step']['max_abs_logit_err']:.3e} (bound {bound_rel:g} x "
        f"max |logit| {out['prefill']['max_abs_logit']:.3f})")
    log(f"[{tag}] against the plain model over the whole batch (not "
        f"gated): prefill {out['prefill']['whole_batch_greedy_equal']} / "
        f"{B} greedy equal, max |logit difference| "
        f"{out['prefill']['whole_batch_max_abs_logit_err']:.3e}; step "
        f"{out['step']['whole_batch_greedy_equal']} / {B}, "
        f"{out['step']['whole_batch_max_abs_logit_err']:.3e}; rounds "
        f"{agree:.1%} of tokens equal")
    log(f"[{tag}] {n_s} stages, N_B {n_mb} x {pcfg.mb_size} rows, "
        f"{tokens}-token prompts on {card}: prefill replayed "
        f"{out['prefill_ms']:.1f} ms ({out['prefill_tok_per_s']:.0f} tok/s; "
        f"eager {out['eager_prefill_ms']:.1f} ms; plain over the batch "
        f"{out['plain_prefill_ms']:.1f} ms, a microbatch at a time "
        f"{out['plain_mb_prefill_ms']:.1f} ms); rounds decode replayed "
        f"{out['rounds_tok_per_s']:.1f} tok/s, eager "
        f"{out['eager_rounds_tok_per_s']:.1f} tok/s, beside "
        f"{out['sequential_tok_per_s']:.1f} tok/s of {rounds} sequential "
        f"plain decode steps over the batch "
        f"({out['sequential_mb_tok_per_s']:.1f} a microbatch at a time); "
        f"bubble share (N_S-1)/(R*N_B+N_S-1) = {bubble:.4f}")
    return out


def phase_fixed_pipe_yi(torch, np, card: str, params):
    """[fixed-pipe]: full yi-9b (48 layers, 2 stages of 24, no epilogue)
    through the fixed-batch passes in bf16 on the yi-9b phase's weights."""
    import gc

    from repro_torch.config import get_arch
    from repro_torch.core import pipeline as PL
    from repro_torch.models.common import Runtime

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch("yi-9b")
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    pcfg = PL.PipelineConfig(FIXED_STAGES, FIXED_N_MB, FIXED_MB)
    if PL.stage_ranges(cfg, FIXED_STAGES)[-1] != (YI_LAYERS, YI_LAYERS):
        raise AssertionError("fixed-pipe: yi-9b at 2 stages has an epilogue")
    rng = np.random.RandomState(SEED)
    tokens = torch.from_numpy(rng.randint(
        1, cfg.vocab_size, (pcfg.global_batch, FIXED_S)).astype(
            np.int32)).cuda()
    run, pc, rc = _fixed_run(torch, cfg, rt, params, pcfg, tokens, FIXED_CAP,
                             FIXED_R, "cuda")
    want = {"paged_attention": 0, "flash_attention": FIXED_N_MB * YI_LAYERS,
            "rglru_scan": 0, "chunk_attention": 0}
    if pc != want or any(rc.values()):
        raise AssertionError(f"fixed-pipe: prefill launches {pc}, want "
                             f"{want}; rounds launches {rc}, want none")
    log(f"[fixed-pipe] one replayed FixedPasses.prefill: "
        f"{pc['flash_attention']} flash launches = N_B {FIXED_N_MB} x "
        f"{YI_LAYERS} layers (each stage call's graph adds its 24); the "
        "decode passes launch no kernel (dense caches, the plain decode "
        "attention, as in the JAX passes)")
    info = _fixed_check("fixed-pipe", run, FIXED_LOGIT_BOUND, card, pcfg,
                        FIXED_R, FIXED_S)
    info["graphs"] = _fixed_graphs("fixed-pipe", run, pcfg, FIXED_R, card)
    info["graph_parity"] = run["graph_parity"]
    info["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[fixed-pipe] peak {info['peak_gib']:.2f} GiB allocated (weights "
        "included)")
    return {"yi-9b fixed-pipe prefill": pc,
            "yi-9b fixed-pipe rounds": rc}, info


def phase_fixed_pipe_rgemma(torch, np, card: str):
    """[fixed-pipe-rgemma]: recurrentgemma-9b at full width, its first 8
    layers, through the fixed-batch passes in bf16: the scan kernel in
    both stages and the epilogue, the flash kernel in the stages."""
    import dataclasses
    import gc

    from repro_torch.config import get_arch
    from repro_torch.core import pipeline as PL
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import Runtime

    cfg = dataclasses.replace(get_arch("recurrentgemma-9b"),
                              num_layers=RG_FIXED_LAYERS)
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    pcfg = PL.PipelineConfig(FIXED_STAGES, RG_FIXED_N_MB, RG_FIXED_MB)
    ranges = PL.stage_ranges(cfg, FIXED_STAGES)
    kinds = cfg.layer_kinds()
    epi = kinds[ranges[-1][0]:]
    if epi != ("rglru", "rglru"):
        raise AssertionError(f"fixed-pipe-rgemma: epilogue {epi}")
    params = model_lib.init_params(cfg, SEED, rt, "cuda")
    rng = np.random.RandomState(SEED + 1)
    tokens = torch.from_numpy(rng.randint(
        1, cfg.vocab_size, (pcfg.global_batch, RG_FIXED_S)).astype(
            np.int32)).cuda()
    run, pc, rc = _fixed_run(torch, cfg, rt, params, pcfg, tokens,
                             RG_FIXED_CAP, RG_FIXED_R, "cuda")
    staged = kinds[:ranges[-1][0]]
    want = {"paged_attention": 0,
            "flash_attention": RG_FIXED_N_MB * staged.count("local"),
            "rglru_scan": RG_FIXED_N_MB * staged.count("rglru") + len(epi),
            "chunk_attention": 0}
    if pc != want or any(rc.values()):
        raise AssertionError(f"fixed-pipe-rgemma: prefill launches {pc}, "
                             f"want {want}; rounds launches {rc}")
    log(f"[fixed-pipe-rgemma] {cfg.num_layers} layers {kinds}: one "
        f"replayed FixedPasses.prefill launches the scan "
        f"{pc['rglru_scan']} times "
        f"(N_B {RG_FIXED_N_MB} x 4 stage layers + 2 epilogue layers over "
        f"the batch) and flash {pc['flash_attention']} times (N_B x 2)")
    info = _fixed_check("fixed-pipe-rgemma", run, FIXED_LOGIT_BOUND, card,
                        pcfg, RG_FIXED_R, RG_FIXED_S)
    info["graphs"] = _fixed_graphs("fixed-pipe-rgemma", run, pcfg,
                                   RG_FIXED_R, card)
    info["graph_parity"] = run["graph_parity"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"recurrentgemma-9b fixed-pipe prefill": pc,
            "recurrentgemma-9b fixed-pipe rounds": rc}, info


def phase_fixed_pipe_parity(torch, np, card_name: str = "the card"):
    """[fixed-pipe-parity]: phase 6's models, float32, through the
    fixed-batch passes on the CPU (the plain versions) and on the card
    (the kernels), identical weights: logits within ``FP_TOL``, greedy
    tokens and rounds equal.  Each depth leaves no attention layer in the
    epilogue."""
    import dataclasses

    from repro_torch.config import get_arch
    from repro_torch.core import pipeline as PL
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import Runtime

    torch.backends.cuda.matmul.allow_tf32 = False     # as phase 6
    torch.backends.cudnn.allow_tf32 = False
    rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
    models = {
        "yi-9b-4layer": dataclasses.replace(
            get_arch("yi-9b"), name="yi-9b-4layer", num_layers=4,
            d_model=512, d_ff=1024, vocab_size=2048),
        "gemma3-local-global": dataclasses.replace(
            get_arch("gemma3-12b"), name="gemma3-local-global",
            num_layers=4, block_pattern=("local", "global"), d_model=512,
            num_heads=8, num_kv_heads=4, head_dim=64, d_ff=1024,
            vocab_size=2048, window_size=32),
        "recurrentgemma-rglru-local": dataclasses.replace(
            get_arch("recurrentgemma-9b"), name="recurrentgemma-rglru-local",
            num_layers=8, d_model=512, d_rnn=512, num_heads=16,
            num_kv_heads=1, head_dim=64, d_ff=1024, vocab_size=2048,
            window_size=32),
    }
    pcfg = PL.PipelineConfig(FIXED_STAGES, FP_N_MB, FP_MB)
    out, counts = {}, {}
    for label, cfg in models.items():
        cpu_params = model_lib.init_params(cfg, SEED, rt, "cpu")
        tokens = np.random.RandomState(SEED + 3).randint(
            1, cfg.vocab_size, (pcfg.global_batch, FP_S)).astype(np.int32)
        runs = {}
        for dev in ("cpu", "cuda"):
            params = _to(cpu_params, dev)
            runs[dev], pc, _ = _fixed_run(
                torch, cfg, rt, params, pcfg,
                torch.from_numpy(tokens).to(dev), FP_CAP, FP_R, dev)
            if dev == "cuda":
                counts[f"{label} fixed-pipe parity"] = pc
                _fixed_graphs(f"fixed-pipe-parity {label}", runs[dev], pcfg,
                              FP_R, card_name)
        cpu, card = runs["cpu"], runs["cuda"]
        errs = {name: (card[name] - cpu[name]).abs().max().item()
                for name in ("logits", "step")}
        same = {name: bool((card[name].argmax(-1) ==
                            cpu[name].argmax(-1)).all())
                for name in ("logits", "step")}
        same["rounds"] = bool((card["rounds"] == cpu["rounds"]).all())
        if max(errs.values()) > FP_TOL or not all(same.values()):
            raise AssertionError(f"fixed-pipe-parity {label}: card vs CPU "
                                 f"max |logit difference| {errs} (tol "
                                 f"{FP_TOL}), greedy equal {same}")
        staged = cfg.layer_kinds()[:PL.stage_ranges(cfg,
                                                   FIXED_STAGES)[-1][0]]
        n_attn = sum(k in ("attn", "local", "global") for k in staged)
        if counts[f"{label} fixed-pipe parity"]["flash_attention"] != \
                FP_N_MB * n_attn:
            raise AssertionError(f"fixed-pipe-parity {label}: flash "
                                 f"launches {counts}")
        log(f"[fixed-pipe-parity] {label} ({cfg.num_layers} layers, "
            f"{cfg.layer_kinds()}): card vs CPU max |logit difference| "
            f"prefill {errs['logits']:.3e}, step {errs['step']:.3e} (tol "
            f"{FP_TOL:g}); greedy prefill, step and {FP_R}-round tokens "
            f"equal; card launches {counts[f'{label} fixed-pipe parity']}")
        out[label] = {"max_abs_logit_err_prefill": errs["logits"],
                      "max_abs_logit_err_step": errs["step"],
                      "greedy_equal": True}
    return counts, out


def phase_market(miner_outs, owner_outs, vocab: int):
    """[market]: the §6 protocol on served output.  The miner is the
    pipelined engine of phase 10's run 1, the task owner's reference the
    local engine it is held against: each of the results is signed,
    verified and paid from its own escrow; every honest dispute is
    dismissed, a result with one token changed (signed by the miner) is
    slashed with the stake going to the owner, and a third party's
    dispute is refused."""
    from repro_torch.framework.arbitration import (ArbitrationModule,
                                                   SignedResult)
    from repro_torch.framework.payment import PaymentModule

    pay = PaymentModule()
    arb = ArbitrationModule(pay)
    pay.deposit("miner", MARKET_STAKE)
    key = arb.register_miner("miner", stake=MARKET_STAKE)
    n = len(miner_outs)
    pay.deposit("owner", MARKET_PRICE * n)
    task = 0
    arb.register_task_owner(task, "owner")
    results, sign_s = [], 0.0
    for o in miner_outs:
        escrow = pay.lock("owner", task, MARKET_PRICE)
        t0 = time.perf_counter()
        r = SignedResult.sign(task, o.request_id, "miner", o.token_ids, key)
        sign_s += time.perf_counter() - t0
        if not (r.verify_signature(key) and r.matches_output(o.token_ids)):
            raise AssertionError(f"market: result {o.request_id} does not "
                                 "verify")
        pay.release(escrow.escrow_id, "miner")
        results.append(r)
    if pay.balance("miner") != MARKET_PRICE * n or pay.balance("owner"):
        raise AssertionError(f"market: balances {pay.balances}")
    outcomes = [arb.open_dispute("owner", r, o.token_ids, ref.token_ids)
                .outcome for r, o, ref in zip(results, miner_outs,
                                              owner_outs)]
    if outcomes != ["dismissed"] * n:
        raise AssertionError(f"market: honest disputes {outcomes}")
    try:
        arb.open_dispute("mallory", results[0], miner_outs[0].token_ids,
                         [0] * len(miner_outs[0].token_ids))
        raise AssertionError("market: a third party's dispute was taken")
    except PermissionError:
        pass
    bad = list(miner_outs[0].token_ids)
    bad[len(bad) // 2] = (bad[len(bad) // 2] + 1) % vocab
    forged = SignedResult.sign(task, n, "miner", bad, key)
    d = arb.open_dispute("owner", forged, bad, owner_outs[0].token_ids)
    if d.outcome != "slashed" or arb.stakes["miner"] != 0.0 or \
            pay.balance("owner") != MARKET_STAKE:
        raise AssertionError(f"market: tampered result {d.outcome}, stake "
                             f"{arb.stakes}, balances {pay.balances}")
    log(f"[market] {n} served results signed, verified and paid from "
        f"{n} escrows ({sign_s / n * 1e6:.1f} µs a signature); {n} honest "
        "disputes against the local engine's streams dismissed; a third "
        "party's dispute refused; a result with one token changed, signed "
        f"by the miner, slashed: the stake of {MARKET_STAKE:g} went to the "
        "owner")
    return {"results": n, "dismissed": n, "slashed": 1,
            "third_party_refused": True, "sign_us": sign_s / n * 1e6}


def phase_examples():
    """[examples]: each example module on the card as a subprocess with
    small arguments, all started together; each must exit 0 and print its
    key lines."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    try:
        for name, (args, _) in EXAMPLES.items():
            module = name.split()[0]
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", f"repro_torch.examples.{module}",
                 *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        out, t0 = {}, time.perf_counter()
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
            wall = time.perf_counter() - t0
            lines = EXAMPLES[name][1]
            missing = [ln for ln in lines if ln not in stdout]
            if proc.returncode != 0 or missing:
                raise AssertionError(
                    f"examples: {name} exited {proc.returncode}, missing "
                    f"{missing}:\n{stdout[-1500:]}\n{stderr[-1500:]}")
            keep = [ln for ln in stdout.splitlines()
                    if any(k in ln for k in lines)]
            log(f"[examples] {name}: exit 0 within {wall:.1f} s of the "
                "start; " + " | ".join(ln.strip() for ln in keep))
            out[name] = {"exit": 0, "done_within_s": wall}
        return out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def phase_fixed_pipeline(torch, np, card: str, params, miner_outs,
                         owner_outs):
    """Phase 15; returns (launch counts by path, the ``fixed_pipe``
    summary)."""
    t0 = time.perf_counter()
    paths, summary = {}, {}
    counts, summary["yi-9b"] = phase_fixed_pipe_yi(torch, np, card, params)
    paths.update(counts)
    counts, summary["recurrentgemma-9b"] = phase_fixed_pipe_rgemma(
        torch, np, card)
    paths.update(counts)
    counts, summary["parity"] = phase_fixed_pipe_parity(torch, np, card)
    paths.update(counts)
    from repro_torch.config import get_arch
    summary["market"] = phase_market(miner_outs, owner_outs,
                                     get_arch("yi-9b").vocab_size)
    summary["examples"] = phase_examples()
    summary["wall_s"] = time.perf_counter() - t0
    log(f"[fixed-pipe] phase 15 wall time {summary['wall_s']:.1f} s")
    return paths, summary


# ---------------------------------------------------------------------------
# phase 16: the dry run's table, and three one-card cells held to it
# ---------------------------------------------------------------------------

# the table runs in a subprocess started with the script (meta tensors
# only, kept off the card, at a lower priority), in DRYRUN_JOBS worker
# processes; it is stopped (SIGSTOP) while the yi-9b serving phases 7-12
# run, whose host-bound stage times set the latency curve's gated ratio
# (chip run 5 of PR 23: T_S 34.2 ms beside a running table, 25.9 ms in
# run 3, and the ratio 2.86x under its 3.0x floor)
DRYRUN_JOBS = 4
DRYRUN_TABLE_BUDGET_S = 1050
DRYRUN_DIR = ROOT / "experiments" / "dryrun_torch"
DRYRUN_LOG = ROOT / "build" / "dryrun_table.log"
# flash launches a counted and a timed run of each checked cell: yi-9b's
# 48 layers a prefill, N_B x 48 a pipelined prefill (no kernel in its
# dense-cache decode step), gemma3-1b's 26 layers a training step
DRYRUN_FLASH = {"dryrun-prefill": 2 * 48, "dryrun-pipe": 2 * 4 * 48,
                "dryrun-train": 2 * 26}


def start_dryrun_table():
    """``python -m repro_torch.launch.dryrun --all`` in the background:
    meta tensors only, so it sees no card (``CUDA_VISIBLE_DEVICES`` empty)
    and one thread a worker; its log goes to ``build/``."""
    DRYRUN_LOG.parent.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    log_f = open(DRYRUN_LOG, "w")
    # its own process group, so that stopping it stops its workers too
    proc = subprocess.Popen(
        ["nice", "-n", "10", sys.executable, "-m",
         "repro_torch.launch.dryrun", "--all", "--jobs", str(DRYRUN_JOBS),
         "--out", str(DRYRUN_DIR)],
        cwd=str(ROOT), env=env, stdout=log_f, stderr=subprocess.STDOUT,
        start_new_session=True)
    proc.log_file = log_f
    return proc


def pause_dryrun_table(proc, pause: bool) -> None:
    """Stop (``pause``) or continue the table's process group, workers
    included; it may have ended already."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGSTOP if pause else signal.SIGCONT)
        log(f"[dryrun] table {'stopped' if pause else 'continued'}")


def stop_dryrun_table(proc) -> None:
    """Kill the table's process group if it still runs (its workers with
    it), and reap it."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        os.killpg(proc.pid, signal.SIGCONT)
    proc.wait()
    proc.log_file.close()


def _dryrun_table(proc, timeout_s: float) -> dict:
    """Wait for the table and check it: every cell ok, or skipped where
    the JAX dry run skips it (the 500k decode of a pure full-attention
    arch); count the cells one H100 holds."""
    from repro_torch.config import SHAPES, get_arch, list_archs
    t0 = time.perf_counter()
    rc = proc.wait(timeout=timeout_s)
    waited = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"[dryrun] the table exited {rc}; see "
                           f"{DRYRUN_LOG}: "
                           + DRYRUN_LOG.read_text()[-2000:])
    recs, fits, dominant = [], [], Counter()
    for arch in list_archs():
        for shape in SHAPES:
            for mesh in ("single_pod", "multi_pod"):
                path = DRYRUN_DIR / f"{arch}__{shape}__{mesh}.json"
                rec = json.loads(path.read_text())
                skip = shape == "long_500k" and \
                    not get_arch(arch).is_subquadratic()
                if not rec["ok"] or rec["skipped"] != skip:
                    raise RuntimeError(f"[dryrun] {path.name}: ok "
                                       f"{rec['ok']}, skipped "
                                       f"{rec['skipped']} (want {skip}): "
                                       f"{rec.get('error')}")
                recs.append(rec)
                if skip:
                    continue
                mem, roof = rec["memory"], rec["roofline"]
                dominant[roof["dominant"]] += 1
                if mem["fits_h100_80gb"]:
                    fits.append(f"{arch}/{shape}/{mesh}")
                log(f"[dryrun-table] {arch} {shape} {mesh}: peak "
                    f"{mem['peak_per_device'] / 1e9:.2f} GB a device "
                    f"({'fits' if mem['fits_h100_80gb'] else 'over'} 80 "
                    f"GB), {roof['dominant']}, bound "
                    f"{roof['bound_step_s'] * 1e3:.3f} ms, traced in "
                    f"{rec['trace_s']:.1f} s")
    traced = sum(not r["skipped"] for r in recs)
    log(f"[dryrun] table: {len(recs)} cells, {traced} traced and ok, "
        f"{len(recs) - traced} skipped as the JAX dry run skips them; "
        f"{len(fits)} of {traced} fit one H100's 80 GB a device; dominant "
        f"terms {dict(dominant)}; waited {waited:.1f} s for it")
    return {"cells": len(recs), "traced": traced,
            "skipped": len(recs) - traced, "fit_one_h100": len(fits),
            "dominant": dict(dominant), "wait_s": waited}


def phase_dryrun(torch, card: str, table_proc, table_timeout_s: float):
    """Phase 16; returns (launch counts by path, the ``dryrun`` summary)."""
    from repro_torch.launch import dryrun as dr
    t0 = time.perf_counter()
    summary = {"table": _dryrun_table(table_proc, table_timeout_s),
               "cells": {}}
    paths, params = {}, None
    for name, build in dr.CHECKS:
        _free_card(torch)
        reset_counts()
        got = dr.check_cell(build, "cuda",
                            params if build is dr._yi_pipe else None)
        counts = read_counts()
        made = got.pop("params")
        params = made if build is dr._yi_prefill else None
        del made
        s = dr.check_summary(name, got)
        bad = dr.gate(s)
        if got["kernel_calls"] != got["predicted"]["kernel_calls"]:
            bad.append(f"kernel calls {got['kernel_calls']} on the card, "
                       f"{got['predicted']['kernel_calls']} predicted")
        if counts["flash_attention"] != DRYRUN_FLASH[name]:
            bad.append(f"flash launches {counts['flash_attention']}, want "
                       f"{DRYRUN_FLASH[name]}")
        a_pred, a_card = s["argument_bytes"]
        p_pred, p_card = s["peak"]
        log(f"[{name}] arguments predicted {a_pred:,} B, card "
            f"memory_allocated {a_card:,} B ({s['argument_rel_err']:.4%}; "
            f"the tensors asked for {s['argument_requested']:,} B); "
            f"flops predicted {s['flops'][0]:,}, counted on the card "
            f"{s['flops'][1]:,} ({'equal' if s['flops_equal'] else 'DIFFER'}"
            f"); peak predicted {p_pred / 2 ** 30:.3f} GiB, card "
            f"max_memory_allocated {p_card / 2 ** 30:.3f} GiB (ratio "
            f"{s['peak_ratio']:.4f}); step {s['step_ms']:.2f} ms, roofline "
            f"bound {s['bound_ms']:.2f} ms ({s['dominant']}), step / bound "
            f"{s['step_over_bound']:.3f}; flash launches "
            f"{counts['flash_attention']}; on {card}")
        if bad:
            raise RuntimeError(f"[{name}] " + "; ".join(bad))
        summary["cells"][name] = s
        paths[name] = counts
    del params
    _free_card(torch)
    summary["wall_s"] = time.perf_counter() - t0
    log(f"[dryrun] phase 16 wall time {summary['wall_s']:.1f} s")
    return paths, summary


# ---------------------------------------------------------------------------
# phase 17: pipeline stages placed by device
# ---------------------------------------------------------------------------

# the mixed drill: yi-9b's widths at 4 layers, float32, stage 0 on the card
# and stage 1 on the CPU, phase 6's parity requests on both wires
MIXED_LAYERS, MIXED_MESH = 4, ("cuda:0", "cpu")
MIXED_NEW = 16
# and a tied head across the boundary: gemma3-1b's widths at two periods
# (12 layers, the exact prefill walking the stages), the first requests
MIXED_TIED_LAYERS, MIXED_TIED_REQUESTS = 12, 6
# the several-card runs: yi-9b over two cards (phase 10's engine), the
# fixed-batch passes (phase 15's geometry), a 2 -> 1 -> 2 reshard after
# these engine steps, full-depth phi3.5-moe over two cards and llama3-70b
# over four
MULTI_RESHARD_STEPS = (20, 40)
LLAMA_MB, LLAMA_N_MB, LLAMA_STAGES = 4, 4, 4


def _gib(nbytes) -> float:
    return nbytes / 2 ** 30


def phase_multi_gpu_mixed(torch, np, card: str):
    """[multi-gpu-mixed]: a real device boundary on one card.  The same
    weights through a 2-stage pipe with ``mesh=["cuda:0", "cuda:0"]`` and
    with ``mesh=["cuda:0", "cpu"]``: the activation, the page tables, the
    positions and the drained tokens cross between the card and the CPU,
    whose stage takes the plain paged attention (the routing rule: the
    plain version serves a CPU tensor).  Float32, as phases 6 and 6c hold
    the CPU against the card: greedy streams equal token for token on the
    fp32 and the int8 wire; then a tied head across the same boundary
    (``_mixed_tied``).  Returns (launch counts by path: the mixed fp32 run
    and the tied one, the summary)."""
    import dataclasses

    from repro_torch.config import get_arch
    from repro_torch.launch.serve import stage_times
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import Runtime
    from repro_torch.serving.backend import stage_devices
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import LLM, EngineConfig
    from repro_torch.serving.request import SamplingParams

    _free_card(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("yi-9b"), num_layers=MIXED_LAYERS)
    rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
    # phase 6's parity requests: 10 prompts of 20-199 tokens, 16 greedy
    # tokens each, through 2 x 4 slots
    rng = np.random.RandomState(SEED + 1)
    lens = rng.randint(20, 200, 10)
    prompts = [list(rng.randint(1, cfg.vocab_size, n)) for n in lens]
    sp = SamplingParams(temperature=0.0, max_new_tokens=MIXED_NEW)
    layout = dict(mb_size=4, num_microbatches=2, pool=PoolConfig(
        page_size=16, n_local_pages=8 * 16 + 1, max_pages_per_seq=16),
        backend="pipelined", n_stages=2, seed=SEED)
    card_mesh = ["cuda:0", "cuda:0"]
    params = model_lib.init_params(cfg, SEED, rt, "cuda:0")
    out, counts = {"layers": MIXED_LAYERS, "requests": len(prompts)}, None
    for wire in ("fp32", "int8"):
        streams, launches = [], []
        for mesh in (card_mesh, list(MIXED_MESH)):
            name = "+".join(mesh)
            llm = LLM(cfg, config=EngineConfig(mesh=mesh, wire_dtype=wire,
                                               **layout),
                      params=params, rt=rt, reduced=False, device="cuda:0")
            be = llm.engine.backend
            moved = llm.engine.moved_bytes
            reset_counts()
            t0 = time.perf_counter()
            outs = llm.generate(prompts, sp)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = read_counts()
            if not all(o.finished and len(o.token_ids) == MIXED_NEW
                       for o in outs):
                raise AssertionError(f"multi-gpu-mixed {name} {wire}: "
                                     "unfinished requests")
            # the CPU stage runs eagerly: only the card's steps replay
            graph_books(torch, f"multi-gpu-mixed {wire} {name}", be,
                        llm.stats())
            streams.append([o.token_ids for o in outs])
            launches.append(c["paged_attention"])
            per_stage = stage_times(cfg, params, rt, 2, "cuda:0", mesh)
            devs = [str(d) for d in be.stage_devices]
            log(f"[multi-gpu-mixed] {wire} wire, stages on {devs} "
                f"({_gib(moved):.3f} GiB of weights placed before the run): "
                f"{len(outs)} greedy streams in {wall:.2f} s wall, "
                f"{be.decode_ticks} decode ticks, paged launches "
                f"{c['paged_attention']}; one single-sequence decode step "
                "a stage, each on its device: "
                + ", ".join(f"stage {s} ({d}) {t * 1e3:.2f} ms"
                            for s, (d, t) in enumerate(zip(devs,
                                                           per_stage))))
            out[f"{wire} {name}"] = {"wall_s": wall,
                                     "stage_ms": [t * 1e3 for t in
                                                  per_stage],
                                     "paged_launches": c["paged_attention"],
                                     "decode_ticks": be.decode_ticks}
            if mesh != card_mesh:
                if be.stage_devices != stage_devices(mesh, 2, "cuda:0"):
                    raise AssertionError(f"multi-gpu-mixed: stages on "
                                         f"{be.stage_devices}")
                if wire == "fp32":
                    counts = c
            del llm, be
        a, b = streams
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        if diff:
            raise AssertionError(f"multi-gpu-mixed {wire}: streams {diff} "
                                 "differ between cuda:0+cuda:0 and "
                                 "cuda:0+cpu")
        if not 0 < launches[1] < launches[0]:
            raise AssertionError(f"multi-gpu-mixed {wire}: paged launches "
                                 f"{launches[1]} with a CPU stage, "
                                 f"{launches[0]} on the card alone")
        log(f"[multi-gpu-mixed] {wire} wire on {card}: all {len(a)} greedy "
            "streams equal token for token, cuda:0+cpu against "
            "cuda:0+cuda:0 (the CPU stage runs the plain paged attention: "
            "the routing rule for a CPU tensor, not a fallback)")
    out["fixed"], fixed_counts = _mixed_fixed(torch, np, card, cfg, rt,
                                              params)
    del params
    out["tied"], tied_counts = _mixed_tied(torch, np, card, prompts,
                                           layout, sp)
    return {"yi-9b 4 layers cuda:0+cpu": counts,
            "yi-9b 4 layers fixed-pipe cuda:0+cpu": fixed_counts,
            "gemma3-1b 12 layers cuda:0+cpu": tied_counts}, out


def _mixed_fixed(torch, np, card: str, cfg, rt, params):
    """[multi-gpu-mixed] through ``FixedPasses``: the mixed drill's model
    (float32) through the fixed-batch passes over ``cuda:0 + cpu`` against
    ``cuda:0 + cuda:0``, at the card-vs-CPU parity geometry of phase 15.
    The card's stage calls and the prefill's embedding replay their
    graphs, the CPU stage, its head and drains run eagerly (the routing
    rule), and the activation and the drained tokens cross between
    replays.  Greedy prefill, step and rounds tokens equal, logits within
    ``FP_TOL`` (float32 sums in other orders on the CPU).  Returns (the
    summary, the mixed run's launch counts)."""
    from repro_torch.core import pipeline as PL
    from repro_torch.models import model as model_lib

    pcfg = PL.PipelineConfig(2, FP_N_MB, FP_MB)
    tokens = torch.from_numpy(np.random.RandomState(SEED + 3).randint(
        1, cfg.vocab_size, (FP_N_MB, FP_MB, FP_S)).astype(np.int32)).to(
            "cuda:0")
    cur = torch.full((FP_N_MB, FP_MB), FP_S, dtype=torch.int32,
                     device="cuda:0")
    runs = {}
    for mesh in (["cuda:0", "cuda:0"], list(MIXED_MESH)):
        devs = [torch.device(d) for d in mesh]
        model_lib.place_params(params, PL.layer_devices(cfg, devs))
        fp = PL.FixedPasses(params, cfg, rt, pcfg, FP_CAP, devices=devs)
        reset_counts()
        t0 = time.perf_counter()
        logits = fp.prefill(tokens)
        tok0 = logits.argmax(-1).to(torch.int32)
        saved = _clone_tree(fp.caches)
        step = fp.decode_step(tok0, cur)
        _put_tree(fp.caches, saved)
        del saved
        rounds = fp.decode_rounds(tok0, cur, rounds=FP_R)
        torch.cuda.synchronize()
        runs["+".join(mesh)] = (logits.cpu(), step.cpu(), rounds.cpu(),
                                fp.graphs.stats(), read_counts(),
                                time.perf_counter() - t0)
        del fp
    (a, b), names = runs.values(), list(runs)
    errs = [(x - y).abs().max().item() for x, y in zip(a[:2], b[:2])]
    same = [bool((x.argmax(-1) == y.argmax(-1)).all())
            for x, y in zip(a[:2], b[:2])] + [torch.equal(a[2], b[2])]
    if max(errs) > FP_TOL or not all(same):
        raise AssertionError(f"multi-gpu-mixed fixed passes: {names[1]} "
                             f"against {names[0]}: max |logit difference| "
                             f"{errs} (tol {FP_TOL}), greedy equal {same}")
    st = b[3]
    card_kinds = {"fixed-embed": 1, "fixed-prefill": FP_N_MB,
                  "fixed-decode": FP_N_MB}
    if st["captures_by_kind"] != card_kinds or \
            set(st["replays_by_device"]) != {"cuda:0"} or \
            a[3]["keys"] != 5 * FP_N_MB + 3:      # stages, heads, drains
        raise AssertionError(f"multi-gpu-mixed fixed passes: graph books "
                             f"{st} ({names[1]}), {a[3]} ({names[0]})")
    log(f"[multi-gpu-mixed] fixed-batch passes through FixedPasses, "
        f"{FP_N_MB} x {FP_MB} rows of {FP_S}, {FP_R} rounds on {card}: "
        f"{names[1]} against {names[0]}: greedy prefill, step and round "
        f"tokens equal, max |logit difference| prefill {errs[0]:.3e}, step "
        f"{errs[1]:.3e} (tol {FP_TOL:g}); the card's {st['captures']} keys "
        f"(stage 0 and the embedding) captured once and replayed "
        f"{st['replays']} times, the CPU stage, heads and drains eager; "
        f"{b[5]:.2f} s wall against {a[5]:.2f} s")
    return {"equal_greedy": True, "max_abs_logit_err": errs,
            "graphs": st, "wall_s": b[5], "card_only_wall_s": a[5]}, b[4]


def _mixed_tied(torch, np, card: str, prompts, layout: dict, sp):
    """[multi-gpu-tied]: a tied head across the mixed drill's boundary.
    gemma3-1b's widths at 12 layers (two periods, one a stage), float32:
    stage 0 embeds from ``embed["tok"]`` on the card, the last stage's
    head reads its copy on the CPU (``models.model.tied_head``), and every
    prompt takes the exact prefill through the stages.  Greedy streams
    equal ``["cuda:0", "cuda:0"]``'s, where the head reads ``tok``
    itself.  Returns (the summary, launch counts of the mixed run)."""
    import dataclasses

    from repro_torch.config import get_arch
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import Runtime
    from repro_torch.serving.llm import LLM, EngineConfig

    _free_card(torch)
    cfg = dataclasses.replace(get_arch("gemma3-1b"),
                              num_layers=MIXED_TIED_LAYERS)
    rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
    params = model_lib.init_params(cfg, SEED, rt, "cuda:0")
    prompts = prompts[:MIXED_TIED_REQUESTS]
    streams, out, counts = [], {}, None
    for mesh in (["cuda:0", "cuda:0"], list(MIXED_MESH)):
        llm = LLM(cfg, config=EngineConfig(mesh=mesh, **layout),
                  params=params, rt=rt, reduced=False, device="cuda:0")
        head = llm.engine.backend.head
        if (head is None) != (mesh[-1] == "cuda:0") or (
                head is not None and head.device.type != "cpu"):
            raise AssertionError(f"multi-gpu-tied {mesh}: head {head}")
        reset_counts()
        t0 = time.perf_counter()
        outs = llm.generate(prompts, sp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = read_counts()
        if not all(o.finished and len(o.token_ids) == MIXED_NEW
                   for o in outs):
            raise AssertionError(f"multi-gpu-tied {mesh}: unfinished")
        streams.append([o.token_ids for o in outs])
        mib = 0.0 if head is None else \
            head.numel() * head.element_size() / 2 ** 20
        name = "+".join(mesh)
        log(f"[multi-gpu-tied] gemma3-1b widths, {MIXED_TIED_LAYERS} "
            f"layers, stages on {name}: {len(outs)} greedy streams in "
            f"{wall:.2f} s wall (exact prefill through the stages); the "
            f"head's table a {mib:.1f} MiB copy on the last stage's device"
            f"; launches {c}")
        out[name] = {"wall_s": wall, "head_copy_mib": mib, "launches": c}
        if head is not None:
            counts = c
        del llm, head
    del params
    diff = [i for i, (x, y) in enumerate(zip(*streams)) if x != y]
    if diff:
        raise AssertionError(f"multi-gpu-tied: streams {diff} differ "
                             "between cuda:0+cuda:0 and cuda:0+cpu")
    log(f"[multi-gpu-tied] on {card}: all {len(prompts)} greedy streams "
        "equal token for token, cuda:0+cpu (the head's copy on the CPU) "
        "against cuda:0+cuda:0")
    return out, counts


def _multi_gpu_kernels(torch, np, dev):
    """Each kernel against its plain version on ``dev`` (a second card), at
    one shape each from phases 3-5."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rs
    rng = np.random.RandomState(SEED)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    errs = {}
    with torch.cuda.device(dev):
        lens = rng.randint(1, 128 * 16 + 1, 16)
        args = paged_case(torch, np, rng, b=16, h=32, hk=4, dh=128, page=16,
                          max_pages=128, lens=lens, dtype=torch.bfloat16,
                          device=dev)
        got = pa.paged_decode_attention(*args)
        want = ref.paged_decode_attention_ref(*args)
        atol, rtol = TOL["bfloat16"]
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
        errs["paged_attention"] = (got.float() - want.float()).abs().max()
        q, k, v = (torch.randn((1, 1024, h, 256), generator=gen, device=dev
                               ).to(torch.bfloat16) for h in (16, 8, 8))
        got = fa.flash_attention(q, k, v, causal=True)
        want = ref.flash_attention_ref(q, k, v, causal=True)
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
        errs["flash_attention"] = (got.float() - want.float()).abs().max()
        a = torch.sigmoid(torch.randn((1, 1024, 4096), generator=gen,
                                      device=dev))
        b = torch.randn((1, 1024, 4096), generator=gen, device=dev)
        h0 = torch.randn((1, 4096), generator=gen, device=dev)
        got = rs.rglru_scan(a, b, h0)
        want = ref.rglru_scan_ref(a, b, h0)
        torch.testing.assert_close(got, want, atol=SCAN_TOL, rtol=SCAN_TOL)
        errs["rglru_scan"] = (got - want).abs().max()
        torch.cuda.synchronize(dev)
    if dev not in pa._workspace or torch.device("cuda", 0) \
            not in pa._workspace:
        raise AssertionError(f"multi-gpu: paged workspaces on "
                             f"{list(pa._workspace)}, want one a card")
    errs = {k: float(v) for k, v in errs.items()}
    log(f"[multi-gpu-kernels] on {dev}: paged decode (yi-9b shapes, bf16) "
        f"max |kernel - plain| {errs['paged_attention']:.3e}, flash (gemma3"
        f"-12b prefill, S 1024, bf16) {errs['flash_attention']:.3e}, scan "
        f"(S 1024, Dr 4096) {errs['rglru_scan']:.3e}; one paged workspace "
        f"a card: {sorted(str(d) for d in pa._workspace)}")
    return errs


def _peaks(torch, n_cards: int) -> list:
    return [_gib(torch.cuda.max_memory_allocated(d)) for d in range(n_cards)]


def _reset_peaks(torch, n_cards: int) -> None:
    for d in range(n_cards):
        torch.cuda.reset_peak_memory_stats(d)


def phase_multi_gpu_yi(torch, np, card: str, params, pipe_outs):
    """[multi-gpu-yi9b], [multi-gpu-reshard], [multi-gpu-fixed]: full
    yi-9b (the yi-9b phase's weights) over ``cuda:0, cuda:1``.  Phase 10's
    offloaded 2-stage engine and requests: the fp32 streams (greedy and
    sampled) equal phase 10's one-card run's, the int8 ones a one-card
    int8 run's; a reshard 2 -> 1 -> 2 mid-run gives phase 10's streams;
    phase 15's fixed-batch passes over both cards equal the one-card passes
    bit for bit (``multi_gpu_fixed``).  The weights go back to
    ``cuda:0`` at the end.  Returns (launch counts by path, the
    summary)."""
    from repro_torch.config import get_arch
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import Runtime
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import LLM, EngineConfig

    cfg = get_arch("yi-9b")
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    two = ["cuda:0", "cuda:1"]
    info, counts = {}, {}

    def engine(mesh, wire):
        _free_card(torch)
        return LLM(cfg, config=EngineConfig(
            mb_size=PIPE_MB, num_microbatches=PIPE_N_MB,
            pool=PoolConfig(page_size=SERVE_PAGE, n_local_pages=OFF_LOCAL,
                            n_global_pages=OFF_GLOBAL,
                            max_pages_per_seq=SERVE_MAX_PAGES),
            seed=SEED, max_prefill_tokens_per_tick=256, backend="pipelined",
            n_stages=2, mesh=mesh, wire_dtype=wire), params=params, rt=rt,
            reduced=False, device="cuda:0")

    def same(tag, outs, ref):
        diff = [o.request_id for o, r in zip(outs, ref)
                if o.token_ids != r.token_ids]
        if diff:
            raise AssertionError(f"{tag}: streams of requests {diff} differ "
                                 "from the one-card run's")

    one_int8 = None
    for mesh, wire in ((["cuda:0", "cuda:0"], "int8"), (two, "fp32"),
                       (two, "int8")):
        llm = engine(mesh, wire)
        be = llm.engine.backend
        tag = f"multi-gpu-yi9b {'+'.join(mesh)} {wire}"
        _reset_peaks(torch, 2)
        outs, rep, c = _serve_yi(torch, np, llm, tag, card)
        peaks = _peaks(torch, 2)
        ref = pipe_outs if wire == "fp32" else one_int8
        if ref is None:
            one_int8 = outs
        else:
            same(tag, outs, ref)
            counts[f"yi-9b two cards {wire}"] = c
            info[wire] = {"decode_tok_per_s": rep["decode_tok_per_s"],
                          "prefill_tok_per_s": rep["prefill_tok_per_s"],
                          "wall_s": rep["generate_wall_s"],
                          "swaps": be.swap_count, "peak_gib": peaks,
                          "placed_gib": _gib(llm.engine.moved_bytes)}
            log(f"[multi-gpu-yi9b] {wire} wire, stages on "
                f"{[str(d) for d in be.stage_devices]}: all "
                f"{len(outs)} streams (greedy and sampled) equal the "
                "one-card run's token for token; "
                f"{be.swap_count} swaps over 2 stage offloaders; "
                f"{_gib(llm.engine.moved_bytes):.2f} GiB of weights moved "
                "to place "
                f"the stages; peak GiB a card {peaks[0]:.2f} / "
                f"{peaks[1]:.2f}")
        del llm, be

    # a reshard 2 -> 1 -> 2 across the cards mid-run
    llm = engine(two, "fp32")
    eng = llm.engine
    prompts, sps = _yi_requests(np, cfg.vocab_size, SERVE_REQUESTS,
                                SERVE_PROMPTS, SERVE_NEW)
    seqs = eng.submit(llm._make_requests(prompts, sps))
    moves, step = [], 0
    todo = dict(zip(MULTI_RESHARD_STEPS, (1, 2)))
    while eng.step():
        step += 1
        if step in todo:
            # the card-to-card copies run on the streams after the
            # rebuild's host seconds: the wall, synchronised on both cards,
            # holds them
            for d in range(2):
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            plan = eng.reshard(n_stages=todo[step])
            for d in range(2):
                torch.cuda.synchronize(d)
            moves.append({"to_stages": todo[step],
                          "moved_gib": _gib(eng.moved_bytes),
                          "rebuild_s": plan["seconds"]["rebuild"],
                          "wall_s": time.perf_counter() - t0,
                          "seconds": plan["seconds"]})
            log(f"[multi-gpu-reshard] step {step}: -> {todo[step]} stage(s) "
                f"on {[str(d) for d in eng.backend.stage_devices]}: "
                f"{moves[-1]['moved_gib']:.2f} GiB of weights and caches "
                f"moved card to card, issued in the rebuild's "
                f"{moves[-1]['rebuild_s']:.3f} s; the whole reshard "
                f"{moves[-1]['wall_s']:.3f} s to both cards' end (drain "
                f"{plan['seconds']['drain']:.3f} s, export "
                f"{plan['seconds']['export']:.3f} s of "
                f"{_gib(plan['bytes_migrated']):.3f} GiB host stores)")
    if len(moves) != 2:
        raise AssertionError(f"multi-gpu-reshard: {len(moves)} reshards in "
                             f"{step} steps")
    from repro_torch.serving.llm import RequestOutput
    same("multi-gpu-reshard", [RequestOutput.from_seq(s) for s in seqs],
         pipe_outs)
    log(f"[multi-gpu-reshard] 2 -> 1 -> 2 stages across the cards: all "
        f"{len(seqs)} streams equal phase 10's one-card run's")
    info["reshard"] = moves
    del llm, eng, seqs

    # phase 15's fixed-batch passes over both cards against one card
    info["fixed"] = multi_gpu_fixed(torch, np, params)
    model_lib.place_params(params, [torch.device("cuda", 0)]
                           * cfg.num_layers)
    return counts, info


def multi_gpu_fixed(torch, np, params) -> dict:
    """[multi-gpu-fixed]: phase 15's fixed-batch passes through
    ``FixedPasses`` over ``cuda:0, cuda:1`` against ``cuda:0, cuda:0``,
    full yi-9b (``params``, placed by stage for each; the caller puts them
    back): prefill logits, the decode step's logits and every round's
    tokens equal bit for bit, and each card replays its own graphs, one
    capture a key (no graph spans two cards).  Returns the summary."""
    from repro_torch.config import get_arch
    from repro_torch.core import pipeline as PL
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import Runtime

    cfg = get_arch("yi-9b")
    rt = Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    two = ["cuda:0", "cuda:1"]
    _free_card(torch)
    pcfg = PL.PipelineConfig(FIXED_STAGES, FIXED_N_MB, FIXED_MB)
    rng = np.random.RandomState(SEED)
    tokens = torch.from_numpy(rng.randint(
        1, cfg.vocab_size, (FIXED_N_MB, FIXED_MB, FIXED_S)).astype(
            np.int32)).to("cuda:0")
    cur = torch.full((FIXED_N_MB, FIXED_MB), FIXED_S, dtype=torch.int32,
                     device="cuda:0")
    runs = []
    for mesh in (["cuda:0", "cuda:0"], two):
        devs = [torch.device(d) for d in mesh]
        model_lib.place_params(params, PL.layer_devices(cfg, devs))
        fp = PL.FixedPasses(params, cfg, rt, pcfg, FIXED_CAP, devices=devs)
        t0 = time.perf_counter()
        logits = fp.prefill(tokens)
        tok0 = logits.argmax(-1).to(torch.int32).to("cuda:0")
        saved = _clone_tree(fp.caches)
        step_logits = fp.decode_step(tok0, cur)
        _put_tree(fp.caches, saved)
        del saved
        rounds = fp.decode_rounds(tok0, cur, rounds=FIXED_R)
        for d in devs:
            torch.cuda.synchronize(d)
        wall = time.perf_counter() - t0
        st = fp.graphs.stats()
        # every stage call, head and drain replays a graph of its own
        # card's (none spans two): one capture a key, replays on each card
        if set(fp.graphs.captures.values()) != {1} or \
                set(st["replays_by_device"]) != {str(d) for d in devs}:
            raise AssertionError(f"multi-gpu-fixed {mesh}: graph books {st}")
        runs.append((logits.cpu(), step_logits.cpu(), rounds.cpu(), wall,
                     st))
        del fp
    a, b = runs
    if not all(torch.equal(x, y) for x, y in zip(a[:3], b[:3])):
        raise AssertionError("multi-gpu-fixed: the passes over two cards "
                             "differ from one card's")
    log(f"[multi-gpu-fixed] phase 15's geometry ({FIXED_N_MB} x {FIXED_MB} "
        f"rows of {FIXED_S}, {FIXED_R} rounds) through FixedPasses over "
        "cuda:0+cuda:1: prefill logits, the decode step's logits and every "
        "round's tokens equal the one-card passes bit for bit; each card "
        f"replays its own stage graphs ({b[4]['replays_by_device']} "
        f"replays, {b[4]['captures']} keys captured once each); "
        f"{a[3]:.2f} s one card, {b[3]:.2f} s two, wall, captures included")
    return {"equal": True, "one_card_s": a[3], "two_cards_s": b[3],
            "graphs": b[4]}


def phase_multi_gpu_full_depth(torch, np, card: str, arch: str,
                               n_cards: int, mb: int, n_mb: int):
    """A model no one card holds, served at full depth with one stage a
    card: the weights drawn placed by stage (no card holds more than its
    share and one layer), the yi-9b phase's 20 requests, every one at full
    length with finite log-probs; each card's peak printed."""
    from repro_torch.config import get_arch
    from repro_torch.core import pipeline as PL
    from repro_torch.models import model as model_lib
    from repro_torch.serving.llm import EngineConfig

    _free_card(torch)
    cfg = get_arch(arch)
    rt = _arch_rt(torch, torch.bfloat16)
    mesh = [f"cuda:{d}" for d in range(n_cards)]
    _reset_peaks(torch, n_cards)
    t0 = time.perf_counter()
    params = model_lib.init_params(
        cfg, SEED, rt, "cuda:0", layer_devices=PL.layer_devices(
            cfg, [torch.device(d) for d in mesh]))
    for d in range(n_cards):
        torch.cuda.synchronize(d)
    init_s = time.perf_counter() - t0
    init_peaks = _peaks(torch, n_cards)
    tag = f"multi-gpu-{arch.split('-')[0]}"
    log(f"[{tag}] {arch} at full depth ({cfg.num_layers} layers, "
        f"{_param_bytes(params) / 1e9:.1f} GB of bf16 weights) drawn placed "
        f"over {mesh} in {init_s:.1f} s; peak GiB a card while drawing "
        + " / ".join(f"{p:.2f}" for p in init_peaks))
    econf = EngineConfig(mb_size=mb, num_microbatches=n_mb,
                         pool=_moe_pool(mb, n_mb), seed=SEED,
                         max_prefill_tokens_per_tick=256,
                         backend="pipelined", n_stages=n_cards, mesh=mesh)
    llm, outs, counts, rep, wall = _arch_serve(
        torch, np, tag, cfg, params, rt, econf, SERVE_REQUESTS,
        SERVE_PROMPTS, SERVE_NEW)
    peaks = _peaks(torch, n_cards)
    be = llm.engine.backend
    log(f"[{tag}] on {card}: {len(outs)}/{SERVE_REQUESTS} requests with "
        f"finite log-probs over stages on "
        f"{[str(d) for d in be.stage_devices]}; peak GiB a card "
        + " / ".join(f"{p:.2f}" for p in peaks))
    del llm, be, params
    _free_card(torch)
    return counts, {"layers": cfg.num_layers, "cards": n_cards,
                    "decode_tok_per_s": rep["decode_tok_per_s"],
                    "prefill_tok_per_s": rep["prefill_tok_per_s"],
                    "wall_s": wall, "init_s": init_s,
                    "peak_gib": peaks, "init_peak_gib": init_peaks}


def phase_multi_gpu(torch, np, card: str, params, pipe_outs,
                    serving: bool = True):
    """Phase 17 while the yi-9b weights are alive: the mixed drill on any
    machine; where two cards are visible, the kernels on ``cuda:1`` and,
    with ``serving``, yi-9b over both.  Returns (launch counts by path,
    the summary)."""
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    info = {"cards": cards, "several_card_runs": cards >= 2}
    log("[multi-gpu-placement] phases 10, 11, 12 and 15 ran their pipes "
        "through the placement path (each engine places its stages' "
        "weights and caches, each backend builds its offloaders on them; "
        "mesh=None is cuda:0 a stage) and gave the streams they are held to")
    counts, info["mixed"] = phase_multi_gpu_mixed(torch, np, card)
    if cards < 2:
        log(f"[multi-gpu] {cards} card visible: the several-card runs did "
            "not run")
    else:
        info["kernels_cuda1"] = _multi_gpu_kernels(
            torch, np, torch.device("cuda", 1))
    if cards >= 2 and serving:
        yi_counts, info["yi-9b"] = phase_multi_gpu_yi(torch, np, card,
                                                      params, pipe_outs)
        counts.update(yi_counts)
    info["serving_runs"] = cards >= 2 and serving
    info["wall_s"] = time.perf_counter() - t0
    log(f"[multi-gpu] phase 17 (with the yi-9b weights) wall time "
        f"{info['wall_s']:.1f} s")
    return counts, info


def phase_multi_gpu_deep(torch, np, card: str, info: dict):
    """Phase 17 once the yi-9b weights are gone, where the cards are
    visible: full-depth phi3.5-moe over two cards, llama3-70b over four.
    Returns the launch counts by path and fills ``info``."""
    cards, counts = torch.cuda.device_count(), {}
    if cards >= 2:
        counts["phi3.5-moe full depth 2 cards"], info["phi3.5-moe"] = \
            phase_multi_gpu_full_depth(torch, np, card,
                                       "phi3.5-moe-42b-a6.6b", 2,
                                       MOE_PIPE_MB, MOE_PIPE_N_MB)
    if cards >= LLAMA_STAGES:
        counts["llama3-70b full depth 4 cards"], info["llama3-70b"] = \
            phase_multi_gpu_full_depth(torch, np, card, "llama3-70b",
                                       LLAMA_STAGES, LLAMA_MB, LLAMA_N_MB)
    elif cards >= 2:
        log(f"[multi-gpu] {cards} cards visible: llama3-70b over four did "
            "not run")
    return counts


def phase_multi_gpu_alone(torch, np) -> dict:
    """Phase 17 by itself: the kernels built, the yi-9b weights made, and
    phase 10's run 1 (2 stages on one card, no offload) served as the
    several-card runs' reference.  Prints and returns the ``multi_gpu``
    summary, with every served path's graph books (each stage's graphs
    replay on its card)."""
    from repro_torch.config import get_arch
    from repro_torch.models.common import Runtime
    from repro_torch.serving.kv_cache import PoolConfig
    from repro_torch.serving.llm import LLM, EngineConfig

    smi_line, _ = phase_card(torch)
    phase_build()
    params = yi_params(torch)
    llm = LLM(get_arch("yi-9b"), config=EngineConfig(
        mb_size=PIPE_MB, num_microbatches=PIPE_N_MB,
        pool=PoolConfig(page_size=SERVE_PAGE, n_local_pages=OFF_BASE_LOCAL,
                        max_pages_per_seq=SERVE_MAX_PAGES),
        seed=SEED, max_prefill_tokens_per_tick=256, backend="pipelined",
        n_stages=PIPE_STAGES), params=params,
        rt=Runtime(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16),
        reduced=False, device="cuda")
    pipe_outs, rep, _ = _serve_yi(torch, np, llm, "pipe", smi_line)
    del llm
    _, info = phase_multi_gpu(torch, np, smi_line, params, pipe_outs)
    info["one_card_pipe"] = {"decode_tok_per_s": rep["decode_tok_per_s"],
                             "prefill_tok_per_s": rep["prefill_tok_per_s"]}
    del params
    phase_multi_gpu_deep(torch, np, smi_line, info)
    info["graphs"] = GRAPH_BOOKS
    print(json.dumps({"multi_gpu": info}))
    return info


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

    table = start_dryrun_table()
    t_start = time.perf_counter()
    try:
        return run_phases(torch, np, table, t_start)
    finally:
        stop_dryrun_table(table)


def timed(t_start: float, name: str, fn, *args, **kwargs):
    """Run one phase, printing its start (seconds since the script began)
    and its seconds."""
    t0 = time.perf_counter()
    log(f"[phase] {name}: start at {t0 - t_start:.1f} s")
    out = fn(*args, **kwargs)
    t1 = time.perf_counter()
    PHASE_SECONDS[name] = t1 - t0
    log(f"[phase] {name}: {t1 - t0:.1f} s (ends at {t1 - t_start:.1f} s)")
    return out


def run_phases(torch, np, table, t_start: float) -> int:
    def phase(name, fn, *args, **kwargs):
        return timed(t_start, name, fn, *args, **kwargs)

    smi_line, name = phase("1 card", phase_card, torch)
    sass = phase("2 build", phase_build)
    paged = phase("3 paged kernel", phase_kernel_paged, torch, np)
    chunk = phase("3b chunk kernel", phase_kernel_chunk, torch, np)
    flash = phase("4 flash kernel", phase_kernel_flash, torch, np)
    scan = phase("5 scan kernel", phase_kernel_scan, torch, np)
    group_sizes = phase("5b group sizes", phase_group_sizes, torch, np)
    phase("6 parity", phase_parity, torch, np)
    phase("6c resilience parity", phase_parity_resilience, torch, np)
    swap_order = phase("6b swap order", phase_swap_order, torch, np,
                       smi_line)
    pause_dryrun_table(table, True)
    params = phase("7 yi-9b weights", yi_params, torch)
    graphs = {"parity": phase("7g graph parity", phase_graph_parity, torch,
                              np, smi_line, params)}
    paths = {}
    paths["yi-9b"], serve_wall, serve_outs = phase(
        "7 yi-9b serve", phase_serve, torch, np, smi_line, params)
    off_counts, offload, local_run = phase(
        "7 yi-9b offload", phase_serve_offload, torch, np, smi_line, params)
    paths.update({f"yi-9b {tag}": c for tag, c in off_counts.items()})
    paths["yi-9b planned"], plan = phase("7 yi-9b planned", phase_plan,
                                         torch, np, smi_line, params)
    pipe_counts, pipeline, int8_outs, pipe_outs = phase(
        "10 pipeline", phase_pipeline, torch, np, smi_line, params,
        local_run)
    paths.update(pipe_counts)
    res_counts, resilience = phase(
        "11 resilience", phase_resilience, torch, np, smi_line, params,
        local_run, serve_wall, pipeline["run2"])
    paths.update(res_counts)
    trace_counts, trace = phase(
        "12 trace", phase_trace, torch, np, smi_line, params,
        dict(outs=serve_outs, counts=paths["yi-9b"]), int8_outs,
        local_run, res_counts)
    paths.update(trace_counts)
    pause_dryrun_table(table, False)
    fixed_counts, fixed_pipe = phase(
        "15 fixed-batch passes", phase_fixed_pipeline, torch, np, smi_line,
        params, pipe_outs, local_run["outs"])
    paths.update(fixed_counts)
    # the several-card serving runs (yi-9b, its reshard and passes over two
    # cards, full-depth phi3.5-moe and llama3-70b: 261.4-279.8 s on four
    # cards, chip runs 2 and 8 of PR 24) would take the whole script past
    # its limit there: phase_multi_gpu_alone runs them
    multi_counts, multi_gpu = phase(
        "17 multi-gpu", phase_multi_gpu, torch, np, smi_line, params,
        pipe_outs, serving=False)
    paths.update(multi_counts)
    del params
    if multi_gpu["several_card_runs"]:
        log("[multi-gpu] the several-card serving runs are "
            "phase_multi_gpu_alone's, not the whole script's")
    paths["gemma3-12b"], gemma_outs, gemma_params = phase(
        "8 gemma3-12b serve", phase_serve_gemma, torch, np, smi_line)
    paths["gemma3-12b traced"], trace["gemma"] = phase(
        "12 trace gemma3-12b", phase_trace_gemma, torch, np, smi_line,
        gemma_params, gemma_outs, paths["gemma3-12b"])
    del gemma_params
    paths["recurrentgemma-9b"] = phase(
        "9 recurrentgemma-9b serve", phase_serve_recurrentgemma, torch, np,
        smi_line)
    archs = {"parity": phase("13 arch parity", phase_arch_parity, torch,
                             np)}
    for tag, fn in (("minitron", phase_minitron), ("xlstm", phase_xlstm),
                    ("moe-phi", phase_moe_phi),
                    ("moe-qwen3", phase_moe_qwen3)):
        arch_counts, archs[tag] = phase(f"13 {tag}", fn, torch, np,
                                        smi_line)
        paths.update(arch_counts)
    train_counts, train = phase("14 front ends and training",
                                phase_frontends_and_training, torch, np,
                                smi_line)
    paths.update(train_counts)
    # the table has had the whole run so far; it may take what is left of
    # DRYRUN_TABLE_BUDGET_S from the script's start
    dry_counts, dryrun = phase(
        "16 dry run", phase_dryrun, torch, smi_line, table,
        max(60.0, DRYRUN_TABLE_BUDGET_S - (time.perf_counter() - t_start)))
    paths.update(dry_counts)
    graphs["paths"] = GRAPH_BOOKS
    graphs["exact_parity"] = EXACT_PARITY
    graphs["phase_seconds"] = PHASE_SECONDS
    graphs["script_seconds"] = time.perf_counter() - t_start

    def launches(kernel):
        by_path = {path: c.get(kernel, 0) for path, c in paths.items()}
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
         "training": train["flash_grad"],
         "lse_instances": sass["flash_lse_instances"],
         "sass": sass["flash_attention"]},
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan.py:54",
         "ok": True, **launches("rglru_scan"), **scan,
         "reversed": train["scan_grad"],
         "sass": sass["rglru_scan"]},
        {"name": "paged_chunk_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/chunk_attention.cu",
         "replaces": None, "ok": True, **launches("chunk_attention"),
         "cells": chunk, "sass": sass["chunk_attention"]},
    ]
    print(json.dumps({"offload": {"swap_order": swap_order,
                                  "serve": offload, "plan": plan}}))
    print(json.dumps({"pipeline": pipeline}))
    print(json.dumps({"resilience": resilience}))
    print(json.dumps({"trace": trace}))
    print(json.dumps({"archs": archs}))
    print(json.dumps({"train": train}))
    print(json.dumps({"fixed_pipe": fixed_pipe}))
    print(json.dumps({"dryrun": dryrun}))
    print(json.dumps({"multi_gpu": multi_gpu}))
    print(json.dumps({"graphs": graphs}))
    print(json.dumps({"kernels": entries}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
