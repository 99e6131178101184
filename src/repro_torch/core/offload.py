"""KV-cache offloading (DeServe §4.2): capacity formulas and the
double-buffer global-pool swapper (counterpart of ``repro.core.offload``).

Formula 2 sizes each global pool so that a full swap (out + in) hides
under one pipeline stage time:      M_G = W · T_S
Formula 1 gives the per-microbatch KV capacity with offloading:
      M_B' = (M_KV − 2·M_G) / N_B + M_G
whose floor M_G is *independent of N_B* — the synergy that lets microbatch
scheduling (§4.3) add in-flight microbatches without starving batch size.

On the GPU the swap path is PCIe.  :class:`DoubleBufferOffloader` keeps the
JAX package's schedule and books (pool parity, swap-out of the departing
microbatch, swap-in of the arriving one, ``swap_count`` and
``bytes_swapped``) and moves the copies onto a CUDA copy stream with pinned
host buffers and events; see its docstring.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.serving.kv_cache import PoolConfig, global_slice

# default bandwidth (bytes/s): the paper's setting, PCIe 4.0 x16 effective
PCIE4_BW = 24e9
# swaps whose event pairs are kept for swap_timings()
MAX_TIMED_SWAPS = 4096


def global_pool_bytes(bandwidth: float, stage_time: float) -> float:
    """Formula 2: the largest pool a stage-time-long swap can move."""
    return bandwidth * stage_time


def per_microbatch_capacity(m_kv: float, m_g: float, n_b: int) -> float:
    """Formula 1: per-microbatch KV bytes with offloading enabled."""
    m_g = min(m_g, m_kv / 2.0)
    return (m_kv - 2.0 * m_g) / n_b + m_g


def per_microbatch_capacity_no_offload(m_kv: float, n_b: int) -> float:
    return m_kv / n_b


def batch_size_from_capacity(capacity_bytes: float,
                             kv_bytes_per_seq: float) -> int:
    return max(0, int(capacity_bytes // max(kv_bytes_per_seq, 1.0)))


@dataclass
class OffloadPlan:
    """Concrete page accounting for an engine/pipeline stage."""
    pool: PoolConfig
    bandwidth: float
    stage_time: float
    n_microbatches: int
    page_bytes: int                   # bytes per page across paged layers

    @classmethod
    def derive(cls, *, m_kv_bytes: float, page_bytes: int, page_size: int,
               max_pages_per_seq: int, bandwidth: float, stage_time: float,
               n_microbatches: int) -> "OffloadPlan":
        m_g = global_pool_bytes(bandwidth, stage_time)
        m_g = min(m_g, m_kv_bytes / 2.0)
        n_global = int(m_g // page_bytes)
        n_local = max(2, int((m_kv_bytes - 2 * m_g) // page_bytes))
        pool = PoolConfig(page_size=page_size, n_local_pages=n_local,
                          n_global_pages=n_global,
                          max_pages_per_seq=max_pages_per_seq)
        return cls(pool=pool, bandwidth=bandwidth, stage_time=stage_time,
                   n_microbatches=n_microbatches, page_bytes=page_bytes)

    @property
    def m_g_bytes(self) -> float:
        return self.pool.n_global_pages * self.page_bytes

    @property
    def m_kv_bytes(self) -> float:
        return self.pool.n_pages * self.page_bytes

    def capacity_with_offload(self) -> float:
        return per_microbatch_capacity(self.m_kv_bytes, self.m_g_bytes,
                                       self.n_microbatches)

    def capacity_without_offload(self) -> float:
        return per_microbatch_capacity_no_offload(self.m_kv_bytes,
                                                  self.n_microbatches)


class DoubleBufferOffloader:
    """Double-buffer swapper over the engine's paged pools, in place.

    Microbatch ``m`` owns global pool parity ``m % 2``.  ``ensure_resident``
    swaps the departing microbatch's slice of that parity (the page rows
    ``global_slice(pool, m % 2)`` of every paged layer's K and V pools) to
    its host store and the arriving one's back in; a microbatch with no
    host copy yet gets zeros (stale KV is masked by the sequence lengths
    anyway, but must never be observable).  The books are the JAX
    offloader's: ``resident`` (parity -> microbatch), the host store keyed
    by microbatch, ``swap_count`` and ``bytes_swapped`` (both directions,
    the zero-fill included).

    On a CUDA pool with ``async_swap=True`` no stream is ever synchronised
    here.  The offloader owns one side copy stream and one pinned host
    buffer per microbatch, allocated at that microbatch's first swap-out
    and reused.  A swap records an event on the compute stream (the
    current stream), makes the copy stream wait on it, copies the
    departing slice D2H into the departing microbatch's buffer, then the
    arriving one's buffer H2D (or zeros) into the slice, on the same copy
    stream, so the slice is never overwritten before its snapshot is
    taken; the compute stream then waits on an event recorded after the
    copies.  Reusing a buffer is safe because a microbatch's swap-in (which
    reads its buffer) and its next swap-out (which writes it) are ordered
    on that one stream.  The pools are long-lived, so no memory the copy
    stream reads is ever handed to anyone else.  Each swap's copy-stream
    span and the compute stream's wait span are event pairs, read only by
    :meth:`swap_timings`, outside the swap window.

    ``async_swap=False`` does the copies on the compute stream and blocks
    after the swap-out, as the JAX offloader's blocking mode does.  On a
    CPU pool (the caller's choice of device) the copies are plain
    ``copy_``."""

    def __init__(self, pool: PoolConfig, num_microbatches: int,
                 async_swap: bool = True):
        self.pool = pool
        self.num_microbatches = num_microbatches
        self.async_swap = async_swap
        self.resident: Dict[int, Optional[int]] = {0: None, 1: None}
        # mb -> its swapped-out slices (views of its host buffer)
        self._host: Dict[int, List[torch.Tensor]] = {}
        # mb -> its host buffer (pinned on the card), kept for reuse
        self._buffers: Dict[int, torch.Tensor] = {}
        self._device: Optional[torch.device] = None    # the pools'
        self._stream: Optional[torch.cuda.Stream] = None
        # (copy start, copy end, wait start, wait end) events a swap
        self._timings: deque = deque(maxlen=MAX_TIMED_SWAPS)
        self.swap_count = 0
        self.bytes_swapped = 0

    @property
    def host_bytes(self) -> int:
        """Bytes of host buffer allocated (pinned on the card)."""
        return sum(b.numel() * b.element_size()
                   for b in self._buffers.values())

    @staticmethod
    def _slices(caches: dict, sl: slice) -> List[torch.Tensor]:
        """The parity's page rows of every paged layer's K and V pools:
        views of the long-lived pools (axis 0 is the page axis, so each
        view is contiguous)."""
        return [layer[name][sl] for layer in caches["layers"]
                if "k_pages" in layer for name in ("k_pages", "v_pages")]

    def _buffer(self, mb: int, slices: List[torch.Tensor]
                ) -> List[torch.Tensor]:
        """``mb``'s host buffer cut into one view per slice: one flat
        allocation, pinned when the pools are on the card."""
        buf = self._buffers.get(mb)
        if buf is None:
            dev = slices[0].device
            buf = torch.empty(sum(s.numel() for s in slices),
                              dtype=slices[0].dtype,
                              pin_memory=dev.type == "cuda")
            if dev.type == "cuda" and not buf.is_pinned():
                raise RuntimeError("offload: the host buffer is not pinned; "
                                   "a D2H copy into pageable memory would "
                                   "be synchronous")
            self._buffers[mb] = buf
        views, at = [], 0
        for s in slices:
            views.append(buf[at:at + s.numel()].view(s.shape))
            at += s.numel()
        return views

    def ensure_resident(self, caches: dict, mb: int) -> dict:
        parity = mb % 2
        if self.resident[parity] == mb or self.pool.n_global_pages == 0:
            return caches
        out_mb = self.resident[parity]
        incoming = self._host.pop(mb, None)
        slices = self._slices(caches, global_slice(self.pool, parity))
        if slices and (out_mb is not None or incoming is not None):
            self._device = slices[0].device
            if self._device.type == "cuda" and self.async_swap:
                self._swap_on_copy_stream(slices, out_mb, incoming)
            else:
                if out_mb is not None:
                    self._host[out_mb] = self._stage_out(slices, out_mb)
                self._stage_in(slices, incoming)
        self.resident[parity] = mb
        self.swap_count += 1
        return caches

    def _swap_on_copy_stream(self, slices, out_mb, incoming) -> None:
        dev = slices[0].device
        compute = torch.cuda.current_stream(dev)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        copy = self._stream
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[2].record(compute)           # compute's writes to the slice
        copy.wait_event(ev[2])          # are enqueued: the snapshot waits
        ev[0].record(copy)
        with torch.cuda.stream(copy):
            if out_mb is not None:
                self._host[out_mb] = self._stage_out(slices, out_mb)
            self._stage_in(slices, incoming)
        ev[1].record(copy)
        compute.wait_event(ev[1])
        ev[3].record(compute)
        self._timings.append(ev)

    def _stage_out(self, slices, out_mb: int) -> List[torch.Tensor]:
        """Snapshot the departing microbatch's slices into its host buffer
        on the current stream (the copy stream in async mode)."""
        store = self._buffer(out_mb, slices)
        for dst, src in zip(store, slices):
            dst.copy_(src, non_blocking=True)
            self.bytes_swapped += src.numel() * src.element_size()
        if self._device.type == "cuda" and not self.async_swap:
            # repro-audit: allow(host-sync, offload-sync) — async_swap=False opt-out: the blocking swap-out kept for debugging and A/B runs
            self.block_until_ready()
        return store

    def _stage_in(self, slices, incoming: Optional[List[torch.Tensor]]
                  ) -> None:
        """Write the arriving microbatch's host copy into the slices, or
        zeros when it has none, on the current stream."""
        for i, dst in enumerate(slices):
            if incoming is None:
                dst.zero_()
            else:
                dst.copy_(incoming[i], non_blocking=True)
            self.bytes_swapped += dst.numel() * dst.element_size()

    def block_until_ready(self) -> None:
        """Wait for every copy this offloader has enqueued: the copy
        stream's in async mode, the compute stream's in blocking mode."""
        if self._stream is not None:
            self._stream.synchronize()
        if not self.async_swap and self._device is not None and \
                self._device.type == "cuda":
            torch.cuda.current_stream(self._device).synchronize()

    def settle(self) -> "DoubleBufferOffloader":
        """Block until every in-flight copy has landed: the barrier outside
        the swap window (drain, shutdown, reading the timings)."""
        self.block_until_ready()
        return self

    def swap_timings(self) -> Tuple[List[float], List[float]]:
        """``(copy_ms, wait_ms)`` of the timed swaps since the last call,
        oldest first: each swap's span on the copy stream and the compute
        stream's wait for it.  Settles first; the pairs are dropped once
        read."""
        self.settle()
        copy_ms, wait_ms = [], []
        while self._timings:
            c0, c1, w0, w1 = self._timings.popleft()
            w1.synchronize()
            copy_ms.append(c0.elapsed_time(c1))
            wait_ms.append(w0.elapsed_time(w1))
        return copy_ms, wait_ms
