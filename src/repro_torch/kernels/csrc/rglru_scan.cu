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
// with Dr a multiple of 4 and a, b and out 16-byte aligned: TMA's rules for
// a global tensor (each row stride and the base a multiple of 16 bytes).
//
// It computes what that kernel computes, not how.  The TPU kernel tiles
// (S, Dr) into VMEM blocks, pads S and Dr to the block sizes, and carries h
// across the sequential grid axis in VMEM scratch.  On the card blocks run
// in parallel and in no order, so nothing can be carried between them: a
// lane owns one (row, channel) and carries h in a register over the whole
// of S.  Nothing is padded in device memory; channels past Dr and steps
// past S are never written.
//
// Each step is __fmul_rn, then __fadd_rn: two roundings, as the plain
// version (kernels/ref.py rglru_scan_ref) takes them.  Written as a * h + b,
// nvcc would contract the step into one FMA and round once, and the kernel
// would no longer agree with the plain version bit for bit.  For the same
// reason the chain is not split across S: a two-pass scan (per-chunk
// products of a, then a fix-up) would give more threads but re-associate
// the recurrence, and its results would differ from the plain loop's in
// the last bits.
//
// What bounds it on this card: bytes.  A step reads a_t and b_t and writes
// h_t, 12 bytes for 2 flops, so the least time is 12 * B * S * Dr bytes
// over the memory rate (0.060 ms at B = 1, S = 4096, Dr = 4096).  The
// chain's own arithmetic is about 8 cycles a step (a dependent multiply
// and add), some 19 us for 4,096 steps, well under that.  But only
// B * Dr / 32 warps carry chains (128 at the serving shape, one an SM), so
// a warp's own loads cannot put enough bytes in flight: by Little's law
// 3.35 TB/s over about a microsecond of latency needs some 25-35 KB in
// flight on each SM.  What the design does about it:
//   * a block takes 32 consecutive channels of one row (a 128-byte line a
//     step; 128 blocks at B = 1, Dr = 4096) and has two warps: a producer,
//     one lane of which issues TMA tile loads, and the consumer, which
//     carries the 32 chains;
//   * a and b come through a ring of kStages stages in shared memory, each
//     a (kSteps steps x 32 channels) box of a and of b (8 KB each), loaded
//     by TMA (rank-3 maps over (Dr, S, B)) and handed over on full / empty
//     mbarrier pairs: up to 64 KB of loads in flight a block;
//   * the consumer copies a whole stage into registers before it runs the
//     stage's chain, and hands the stage back at once: the chain then
//     waits on no load, and no store can stand between a load and its use
//     in the compiler's schedule;
//   * a stage's rows are 128 bytes, so lane j reads column j with no bank
//     conflict and no swizzle;
//   * each h_t goes into an output tile in shared memory (double-buffered),
//     which one lane writes out with a TMA store per stage.
// TMA fills zeros past S and Dr on a load and clips the store there, so
// the last stage and the last channel block need no masks: their steps
// past S and channels past Dr are computed on zeros and never stored.
// Variants measured on the card (PERF.md): 32-step stages, 2 to 12
// stages and 64 channels a block came within a few percent of this; so
// did per-step 128-byte global stores, except where nvcc put each masked
// store in a branch of its own, which was far slower; a consumer that read
// the ring inside the chain was bound by the ring's load latency.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 32;   // a block's channels: one 128-byte row
constexpr int kSteps = 64;      // time steps a stage
constexpr int kStages = 4;      // stages of the ring
constexpr int kThreads = 64;    // consumer warp, producer warp
constexpr int kTileFloats = kSteps * kChannels;
constexpr int kTileBytes = kTileFloats * static_cast<int>(sizeof(float));
// a and b rings, two output tiles, the stages' full and empty barriers,
// and 128 bytes to align the tiles as TMA wants them
constexpr int kSmemBytes =
    (2 * kStages + 2) * kTileBytes + 2 * kStages * 8 + 128;
static_assert(kSmemBytes <= 232448, "ring exceeds a block's shared memory");
static_assert(kSteps <= 256, "a TMA box dimension is at most 256");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// spin until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// one TMA box of a rank-3 map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2) : "memory");
}

// one TMA box from shared memory into a rank-3 map, in the thread's bulk
// group; the hardware clips what lies outside the tensor
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2) : "memory");
}

// grid (ceil(Dr / 32), B), kThreads threads, kSmemBytes of shared memory
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map,
                  const __grid_constant__ CUtensorMap out_map,
                  const float* __restrict__ h0, int S, int Dr) {
  extern __shared__ unsigned char smem_raw[];
  // offset, not a rounded integer address: the pointers stay known as
  // shared, so the stage copies compile to LDS
  float* ring_a = reinterpret_cast<float*>(
      smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127));
  float* ring_b = ring_a + kStages * kTileFloats;
  float* out_tiles = ring_b + kStages * kTileFloats;
  uint64_t* bars = reinterpret_cast<uint64_t*>(out_tiles + 2 * kTileFloats);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages);

  const int c0 = blockIdx.x * kChannels;
  const int row = blockIdx.y;
  const int n_tiles = (S + kSteps - 1) / kSteps;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);              // the producer's expect_tx
      mbar_init(empty0 + 8 * s, kChannels);     // every consumer lane
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 32 == 1) {
    // ---- producer: one lane keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(empty0 + 8 * s, ((i / kStages) - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, 2 * kTileBytes);
        tma_load_3d(smem_u32(ring_a + s * kTileFloats), &a_map, full0 + 8 * s,
                    c0, i * kSteps, row);
        tma_load_3d(smem_u32(ring_b + s * kTileFloats), &b_map, full0 + 8 * s,
                    c0, i * kSteps, row);
      }
    }
    return;
  }

  // ---- consumer: lane j carries channel c0 + j over the whole of S
  const int c = c0 + lane;
  float h = (h0 != nullptr && c < Dr) ? h0[(int64_t)row * Dr + c] : 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);
    const float* as = ring_a + s * kTileFloats + lane;
    const float* bs = ring_b + s * kTileFloats + lane;
    float av[kSteps], bv[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      av[j] = as[j * kChannels];
      bv[j] = bs[j * kChannels];
    }
    mbar_arrive(empty0 + 8 * s);
    // the output tile's last store (stage i - 2) must have read it
    float* ot = out_tiles + (i & 1) * kTileFloats;
    if (i >= 2) {
      if (lane == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      h = __fadd_rn(__fmul_rn(av[j], h), bv[j]);
      ot[j * kChannels + lane] = h;
    }
    // the lanes' shared-memory writes, then one lane's TMA store of them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      tma_store_3d(&out_map, smem_u32(ot), c0, i * kSteps, row);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against the CUDA driver library
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A rank-3 float32 map over a contiguous (B, S, Dr) tensor, boxes of
// (32 channels, kSteps steps, 1 row), no swizzle; loads past S or Dr fill
// zeros, stores there are dropped.  Returns 0, or -2 when the CUDA
// driver refuses it.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int Dr) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return -2;
  const cuuint64_t dims[3] = {(cuuint64_t)Dr, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)Dr * 4,
                                 (cuuint64_t)S * Dr * 4};
  const cuuint32_t box[3] = {kChannels, kSteps, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -2;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), a
// cudaFuncSetAttribute error, -1 for a shape or alignment the kernel does
// not take, or -2 when the CUDA driver refuses a tensor map.  Launches on
// `stream` and does not synchronise.  h0 may be null (zeros).
extern "C" int rglru_scan(const void* a, const void* b, const void* h0,
                          void* out, int B, int S, int Dr, void* stream) {
  if (B <= 0 || S <= 0 || Dr <= 0 || B > 65535 || Dr % 4 != 0) return -1;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return -1;
  CUtensorMap a_map, b_map, out_map;
  int rc = make_map(&a_map, a, B, S, Dr);
  if (rc == 0) rc = make_map(&b_map, b, B, S, Dr);
  if (rc == 0) rc = make_map(&out_map, out, B, S, Dr);
  if (rc != 0) return rc;
  const cudaError_t e = cudaFuncSetAttribute(
      rglru_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Dr + kChannels - 1) / kChannels, B);
  rglru_scan_kernel<<<grid, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      a_map, b_map, out_map, static_cast<const float*>(h0), S, Dr);
  return static_cast<int>(cudaGetLastError());
}
