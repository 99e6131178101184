"""Execution backend for the offline serving engine (counterpart of
``repro.serving.backend``; the local backend only).

The engine owns the bookkeeping (queue, slots, page allocator, host page
table, positions); the backend owns the device caches and the compute:

  ``prefill_step(chunk)`` — run one :class:`PrefillChunk` (a fixed-shape
        batch of prompt-token rows with their own page-table rows) and
        return its :class:`PrefillResult`;
  ``prefill(tokens, slot, last_index)`` — the exact-length path: run one
        whole (padded) prompt into ``slot`` and return its last-position
        logits;
  ``reset_slot(slot)`` — clear a reassigned slot's ring positions and
        recurrent states;
  ``decode(mb, tokens, cur_pos, samp)`` — advance microbatch ``mb`` one
        token and return its :class:`DecodeResult`;
  ``set_page_table`` — push the engine's host table to the device.

With an offloader (DeServe §4.2) the backend makes a microbatch's global
pool resident before every model call that may touch it: each residency
microbatch of a prefill chunk, an exact prefill into a slot that holds
global pages, and every decode tick.  Swap copies go on the offloader's
copy stream; every model call, attention kernels included, stays on the
compute stream.

PyTorch runs eagerly, so ``_chunk_fn`` / ``_prefill_fn`` / ``_decode_fn``
are plain methods where the JAX package jits.  The ``PipelinedBackend`` of
§4.3 comes with the pipeline slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.models.common import Runtime
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.sampler import (RowSampling, greedy, gumbel_noise,
                                         sample_batched, token_logprobs)


@dataclass
class DecodeResult:
    """One drained microbatch tick: ``tokens[i]`` is the next token for
    slot ``mb * mb_size + i`` (the engine decides which rows are live)."""
    mb: int
    tokens: np.ndarray                  # (mb_size,) int32
    logprobs: np.ndarray                # (mb_size,) f32, raw-logits logprob


@dataclass
class PrefillChunk:
    """One per-tick prefill work unit: up to R rows of C prompt tokens,
    shapes fixed by the engine (``prefill_rows`` x ``prefill_chunk``);
    padded rows carry ``n_valid == 0``."""
    tokens: np.ndarray                  # (R, C) int32
    offsets: np.ndarray                 # (R,) int32 tokens already prefilled
    n_valid: np.ndarray                 # (R,) int32 real tokens this chunk
    lasts: np.ndarray                   # (R,) int32 within-chunk index of the
                                        # final prompt token (-1: not final)
    tables: np.ndarray                  # (R, max_pages) int32 table rows
    seqs: list                          # engine-side SequenceState refs
    residency_mbs: tuple = ()           # microbatch ids (at most one per
                                        # global-pool parity) whose global
                                        # pool the chunk's rows write


@dataclass
class PrefillResult:
    """A finished prefill chunk: ``logits[i]`` are row ``i``'s
    last-position logits, meaningful only where ``chunk.lasts[i] >= 0``.
    They stay on the device (the engine samples first tokens there)."""
    chunk: PrefillChunk
    logits: torch.Tensor                # (R, V) float32, on the device


class LocalBackend:
    """The single-device path: one model call per prefill chunk and one per
    microbatch decode tick, over an ``mb_size`` row view of the caches."""

    name = "local"

    def __init__(self, cfg: ModelConfig, params: dict, rt: Runtime, *,
                 mb_size: int, num_microbatches: int, pool: kvc.PoolConfig,
                 device: torch.device, offloader=None):
        self.cfg = cfg
        self.params = params
        self.rt = rt
        self.mb_size = mb_size
        self.num_microbatches = num_microbatches
        self.batch = mb_size * num_microbatches
        self.pool = pool
        self.device = device
        self.caches = kvc.build_paged_caches(cfg, self.batch, pool, rt, device)
        self.offloader = offloader
        self.noise_gen = torch.Generator(device=device)
        self.decode_ticks = 0           # model decode calls (kernel ticks)

    def set_page_table(self, table: np.ndarray) -> None:
        self.caches = kvc.set_page_table(self.caches, table)

    def reset_slot(self, slot: int) -> None:
        """Clear a reassigned slot's per-row state (ring positions,
        recurrent states), in place."""
        self.caches = kvc.reset_slot(self.caches, slot)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _residency(self, mb: int) -> None:
        """Make ``mb``'s global-pool parity resident before the model
        writes or reads it (without this a prefill could write prompt KV
        into another microbatch's content, which the next swap would
        clobber).  Callers copy their host inputs to the card first: a
        blocking host-to-device copy synchronises the compute stream, which
        after this call waits on the swap, so a copy made later would hold
        the host for the whole swap instead of letting it issue the model's
        launches meanwhile."""
        if self.offloader is not None:
            self.caches = self.offloader.ensure_resident(self.caches, mb)

    @property
    def swap_count(self) -> int:
        return self.offloader.swap_count if self.offloader else 0

    # -- exact-length prefill ------------------------------------------------

    def prefill(self, tokens: np.ndarray, slot: int, last_index: int,
                has_global_pages: bool = True) -> torch.Tensor:
        """Prefill one whole prompt, right-padded to ``len(tokens)``, into
        ``slot``; returns its logits (V,) at ``last_index``, on the
        device."""
        toks = self._tensor(tokens[None])
        if has_global_pages:
            self._residency(slot // self.mb_size)
        logits = self._prefill_fn(self.params, self.caches, toks, slot,
                                  last_index, cfg=self.cfg, rt=self.rt)
        if self.device.type == "cuda":
            # as prefill_step: the prefill phase's clock measures the card
            torch.cuda.synchronize(self.device)
        return logits

    @staticmethod
    def _prefill_fn(params, caches, tokens, slot, last_idx, *, cfg, rt):
        """One sequence into the batch-wide caches at ``slot``: a one-row
        view of the rings, the recurrent states and the page table stands
        in for the JAX package's slot_view / slot_merge (pools, rings and
        states are written in place through it).  Ring positions past the
        true last index are cleaned back to -1 afterwards."""
        view = kvc.slot_view(caches, slot, 1)
        last = torch.full((1,), last_idx, dtype=torch.int32,
                          device=tokens.device)
        logits, _ = model_lib.prefill(params, tokens, cfg, rt, 0,
                                      caches=view, last_index=last)
        for layer in view["layers"]:
            if "pos" in layer:
                layer["pos"].masked_fill_(layer["pos"] > last_idx, -1)
        return logits[0]

    # -- chunked prefill ---------------------------------------------------

    def prefill_step(self, chunk: Optional[PrefillChunk]
                     ) -> List[PrefillResult]:
        if chunk is None:
            return []
        inputs = [self._tensor(a) for a in (chunk.tokens, chunk.offsets,
                                            chunk.n_valid, chunk.lasts,
                                            chunk.tables)]
        for mb in chunk.residency_mbs:
            self._residency(mb)
        logits = self._chunk_fn(self.params, self.caches, *inputs,
                                cfg=self.cfg, rt=self.rt)
        if self.device.type == "cuda":
            # the chunk's work ends inside the engine's prefill phase, so
            # its prefill/decode time split measures the card, not the queue
            torch.cuda.synchronize(self.device)
        return [PrefillResult(chunk=chunk, logits=logits)]

    @staticmethod
    def _chunk_fn(params, caches, tokens, offsets, n_valid, lasts, tables,
                  *, cfg, rt):
        """One prefill chunk: the model sees the chunk's own table rows
        (the device-wide table keeps prefilling slots parked on the scratch
        page until activation); pools are written in place."""
        view = {"layers": caches["layers"], "page_table": tables}
        logits, _ = model_lib.prefill_chunk(params, tokens, view, offsets,
                                            n_valid, lasts, cfg, rt)
        return logits

    # -- decode --------------------------------------------------------------

    def decode(self, mb: int, tokens: np.ndarray, cur_pos: np.ndarray,
               samp: RowSampling, active: bool = True) -> List[DecodeResult]:
        if not active:
            return []
        dev = self.device
        sampled = samp.any_sampled
        noise = gumbel_noise(samp, self.cfg.vocab_size, dev, self.noise_gen) \
            if sampled else None
        inputs = [self._tensor(a) for a in (tokens, cur_pos, samp.temp,
                                            samp.top_k, samp.top_p)]
        self._residency(mb)
        toks, lps = self._decode_fn(
            self.params, self.caches, inputs[0], inputs[1],
            mb * self.mb_size, noise, *inputs[2:], cfg=self.cfg, rt=self.rt,
            mb_size=self.mb_size, sampled=sampled)
        self.decode_ticks += 1
        # the tick's one device-to-host transfer: the engine books the
        # microbatch's tokens on the host
        out = torch.stack([toks.float(), lps]).cpu().numpy()
        return [DecodeResult(mb=mb, tokens=out[0].astype(np.int32),
                             logprobs=out[1])]

    @staticmethod
    def _decode_fn(params, caches, tokens, cur_pos, row0, noise, temp, top_k,
                   top_p, *, cfg, rt, mb_size, sampled):
        """One decode tick over an ``mb_size`` row view of the caches; rows
        outside the microbatch are untouched.  The view aliases the table,
        ring and recurrent-state rows, and pools, rings and states are
        written in place, so there is nothing to merge back.  ``sampled``
        (decided on the host) skips the truncation pass when every row is
        greedy."""
        view = kvc.slot_view(caches, row0, mb_size)
        logits, _ = model_lib.decode_step(params, tokens, view, cur_pos, cfg,
                                          rt)
        if sampled:
            toks = sample_batched(logits, noise, temp, top_k, top_p)
        else:
            toks = greedy(logits)
        return toks, token_logprobs(logits, toks)
