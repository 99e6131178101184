// RG-LRU linear recurrence for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py
// (`rglru_scan_pallas`, kernel body `_rglru_kernel`): the recurrence of the
// Griffin block's RG-LRU,
//
//   h_t = a_t * h_{t-1} + b_t,   h_{-1} = h0 (zeros when h0 is null),
//
//   a, b  (B, S, Dr)  float32, contiguous
//   h0    (B, Dr)     float32, or null
//   out   (B, S, Dr)  float32: every h_t
//
// It computes what that kernel computes, not how.  The TPU kernel tiles
// (S, Dr) into VMEM blocks, pads S and Dr to the block sizes, and carries h
// across the sequential grid axis in VMEM scratch.  On the card blocks run
// in parallel and in no order, so nothing can be carried between them: a
// thread owns one (row, channel) and carries h in a register over the
// whole of S.  Nothing is padded; channels past Dr and steps past S are
// never read or written.
//
// Each step is __fmul_rn, then __fadd_rn: two roundings, as the plain
// version (kernels/ref.py rglru_scan_ref) takes them.  Written as a * h + b,
// nvcc would contract the step into one FMA and round once, and the kernel
// would no longer agree with the plain version bit for bit.
//
// What bounds it on this card: bytes.  A step reads a_t and b_t and writes
// h_t, 12 bytes for 2 flops, so the least time is 12 * B * S * Dr bytes
// over the memory rate (0.060 ms at B = 1, S = 4096, Dr = 4096).  The
// recurrence is serial in t, so the only parallelism is B * Dr threads
// (4,096 at the serving shape), far too few to keep the memory busy one
// load at a time.  What the design does about it:
//   * loads of a_t and b_t are coalesced: the 32 threads of a warp take 32
//     consecutive channels, one 128-byte line a step;
//   * blocks of 32 channels, so that B = 1, Dr = 4096 gives 128 blocks for
//     the 132 SMs;
//   * the loop runs in groups of kUnroll steps and loads the next group's
//     a and b into registers before it runs this group's dependent chain of
//     multiply-adds, so up to 2 * kUnroll loads a thread are in flight.
// Not yet done (later work): a two-pass scan that splits S across blocks
// (per-chunk (prod a, h) summaries, then a fix-up), which would put more
// threads on the card than B * Dr; TMA bulk loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 32;   // threads a block: consecutive channels
constexpr int kUnroll = 16;     // time steps a group

__global__ void __launch_bounds__(kChannels)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ out,
                  int S, int Dr) {
  const int c = blockIdx.x * kChannels + threadIdx.x;
  const int row = blockIdx.y;
  if (c >= Dr) return;
  const int64_t base = (int64_t)row * S * Dr + c;
  const float* ap = a + base;
  const float* bp = b + base;
  float* op = out + base;
  float h = h0 != nullptr ? h0[(int64_t)row * Dr + c] : 0.f;

  float av[kUnroll], bv[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    av[j] = 0.f;
    bv[j] = 0.f;
    if (j < S) {
      av[j] = ap[(int64_t)j * Dr];
      bv[j] = bp[(int64_t)j * Dr];
    }
  }
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    // the next group's loads go out before this group's chain
    const int t1 = t0 + kUnroll;
    float an[kUnroll], bn[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      an[j] = 0.f;
      bn[j] = 0.f;
      if (t1 + j < S) {
        an[j] = ap[(int64_t)(t1 + j) * Dr];
        bn[j] = bp[(int64_t)(t1 + j) * Dr];
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (t0 + j < S) {
        h = __fadd_rn(__fmul_rn(av[j], h), bv[j]);
        op[(int64_t)(t0 + j) * Dr] = h;
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      av[j] = an[j];
      bv[j] = bn[j];
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// shape the kernel does not take.  Launches on `stream` and does not
// synchronise.  h0 may be null (zeros).
extern "C" int rglru_scan(const void* a, const void* b, const void* h0,
                          void* out, int B, int S, int Dr, void* stream) {
  if (B <= 0 || S <= 0 || Dr <= 0 || B > 65535) return -1;
  const dim3 grid((Dr + kChannels - 1) / kChannels, B);
  rglru_scan_kernel<<<grid, kChannels, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), S, Dr);
  return static_cast<int>(cudaGetLastError());
}
