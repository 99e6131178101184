// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention_pallas`, kernel body `_flash_kernel`): causal and/or
// sliding-window GQA attention over whole sequences, the attention of every
// layer of an exact-length prefill.  It computes what that kernel computes,
// not how: the TPU grid's sequential kv axis becomes a loop inside a CUDA
// block, and only the kv tiles that intersect the block's span are visited.
//
//   q    (B, Sq, H, Dh)    bf16 or f32, head h = kv_head * G + g
//   k/v  (B, Skv, Hk, Dh)  q's dtype
//   out  (B, Sq, H, Dh)    q's dtype; float32 accumulation
//   lse  (B, Hk, G, Sq)    float32, optional (null: not written): each
//                          score row's log-sum-exp m + log(max(l, 1e-30)),
//                          natural log, what a training backward needs
//
// Query position i sees key j when j < Skv, and j <= i if causal, and
// j > i - window if window > 0.  Scores are scaled by 1/sqrt(Dh) (the
// caller passes the scale), masked with the finite NEG_INF = -1e30, and
// run through an online softmax with float32 (m, l, acc); l is floored at
// 1e-30 in the finish.  A masked score contributes p = 0 exactly, so a
// row that sees no key at all is exact zeros.  Rows past Sq and keys past
// Skv are never read from device memory: their tile slots hold zeros.
//
// What bounds it on this card: at prefill lengths, operations.  Each
// (query, visible key) pair costs 4 * Dh flops per head against 2 * Dh
// bytes of K and V that are shared by every query of a tile, so the work
// is far above the card's ~295 flops per byte.  Both paths fold the G
// query heads of a kv head into a block's score rows (row r is position
// q0 + r / G, head r % G), so one load of each K/V tile serves all G heads
// (GQA reuse), and both visit only the kv tiles from the first inside the
// window to the last at or below the diagonal, as the TPU kernel's
// pl.when(live) skips dead blocks.
//
// bf16 (every Dh in {64, 128, 256} x G in {1, 2, 4, 8, 16}): one
// warp-specialised kernel built on Hopper's tensor memory accelerator
// (TMA) and warpgroup matrix multiply (wgmma), which alone reach the
// tensor cores' full rate:
//   * a block owns 128 score rows (128 / G positions x G heads) and has
//     three warpgroups: one producer warp issues every load, and two
//     consumer warpgroups own 64 rows each; setmaxnreg moves registers
//     from the producer (40) to the consumers (232), which hold the
//     float32 output accumulator (Dh / 2 registers a thread);
//   * loads go through TMA into shared memory: the Q tile once, then K and
//     V tiles of 64 keys into a ring of 2 (Dh 256), 3 (128) or 4 (64)
//     stages with mbarrier full / empty pairs, so the next tiles arrive
//     while the consumers compute.  The tensor maps are rank 4 over
//     (Dh, heads, S, B), so TMA fills zeros past Sq or Skv within each
//     batch row and nothing past them is read (NaN there never meets a
//     zero weight in P.V).  Boxes are 64 dims wide (128 bytes, the
//     128-byte swizzle that wgmma reads without bank conflicts); a Dh of
//     256 takes 4 boxes a tile.  The Q box (64 dims, G heads, 128 / G
//     positions) lands as exactly the block's 128 score rows;
//   * S = Q K^T is wgmma m64n64k16 with both operands in shared memory
//     (K-major); O += P V is one wgmma m64n{Dh}k16 a 16-key step with P
//     from registers (the S accumulator's layout is the register A
//     fragment, as in FlashAttention-3) and V in shared memory (MN-major,
//     transposed by the instruction; its Dh / 64 boxes are the atoms).
//     P enters as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi),
//     so it keeps 16 bits of mantissa (error below
//     2**-17 of p) and the output stays within one bf16 ulp of the float32
//     plain version; the TPU kernel rounds P once to bf16.  The second
//     product costs tensor-core time the kernel has to spare;
//   * the mask is applied only on tiles that cross the diagonal, a window
//     edge or Skv; a tile wholly outside a warpgroup's rows is not
//     computed at all (the warpgroup only releases its stage);
//   * under causal masking the q tiles are launched longest first, so the
//     blocks with the most kv tiles do not run last;
//   * the log-sum-exp a training step asks for is written by an instance
//     of its own (template flag kLse), beside the row's output: the
//     serving instance compiles without it, so the serving route's code is
//     what it was before the LSE existed.  The float32 kernel below keeps
//     a run-time null check instead: it is not on a serving route that
//     matters (serving runs bf16), and chip_smoke.py's [flash-grad] times
//     it with and without the store at the training shapes.
// What is left on the table (later work): inside a warpgroup the softmax
// of one tile does not overlap the products; only the other warpgroup's
// products run meanwhile, in whatever order the two fall into.  Two
// schedules of FlashAttention-3 were tried and ran slower here
// (PERF.md): issuing the next tile's S before P.V (it spilled at Dh = 256),
// and passing the tensor cores' turn between the warpgroups with named
// barriers (ping-pong).  The output is stored from registers.
// float32 has no tensor-core path that keeps its precision (TF32 would
// round the inputs), so it runs scalar float32 FMAs: kv tiles of 32 keys,
// Q, K (transposed), V and P in shared memory as float32, each thread
// owning 2 rows x 4 keys of the scores and the same 2 rows x Dh/8 dims of
// the output, so every shared-memory load feeds 8 FMAs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "hopper.cuh"

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kRows = 64;        // score rows per block: (64 / G) positions x G
constexpr int kKeys = 32;        // keys per kv tile
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes (4 float32 or 8 bf16 values) -> floats; p is 16-byte aligned.
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int DH>
constexpr int smem_floats() {
  return DH * kRows + DH * kKeys + kKeys * DH + kKeys * kRows;
}

template <typename T, int DH, int G>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Skv, int H, int Hk,
                 int causal, int window, float scale) {
  constexpr int BQ = kRows / G;           // query positions per block
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int DCH = DH / VEC;           // 16-byte chunks per head row
  constexpr int DPT = DH / 8;             // output dims per thread and row
  static_assert(kThreads == 8 * (kRows / 2), "8 threads per row pair");

  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);   // [DH][kRows]
  float* kT = qT + DH * kRows;                    // [DH][kKeys]
  float* vS = kT + DH * kKeys;                    // [kKeys][DH]
  float* pT = vS + kKeys * DH;                    // [kKeys][kRows]

  const int b = blockIdx.x / Hk;
  const int kvh = blockIdx.x % Hk;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 8;                 // keys 4tx.. / dims 4tx + 32i..
  const int r0 = 2 * (tid / 8);           // this thread's rows r0, r0 + 1

  const int64_t q_stride = (int64_t)H * DH;      // position to position
  const int64_t kv_stride = (int64_t)Hk * DH;
  const T* qb = q + (int64_t)b * Sq * q_stride + (int64_t)kvh * G * DH;
  const T* kb = k + (int64_t)b * Skv * kv_stride + (int64_t)kvh * DH;
  const T* vb = v + (int64_t)b * Skv * kv_stride + (int64_t)kvh * DH;
  T* ob = out + (int64_t)b * Sq * q_stride + (int64_t)kvh * G * DH;

  // ---- the Q tile, transposed: row r is (position q0 + r / G, head r % G)
  for (int i = tid; i < kRows * DCH; i += kThreads) {
    const int r = i % kRows;
    const int ch = i / kRows;
    const int qi = q0 + r / G;
    float f[VEC];
    if (qi < Sq) {
      load16(qb + qi * q_stride + (r % G) * DH + ch * VEC, f);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) qT[(ch * VEC + j) * kRows + r] = f[j];
  }

  // the keys this block's queries can see: [lo, hi)
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(Skv, q_last + 1) : Skv;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = q0 + (r0 + i) / G;

  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  float acc[2][DPT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;

  for (int t0 = (lo / kKeys) * kKeys; t0 < hi; t0 += kKeys) {
    __syncthreads();    // the previous tile's reads (and the Q tile) done

    // ---- K tile, transposed (consecutive threads take consecutive keys,
    // so the transposed stores fall in distinct banks), and V tile
    for (int i = tid; i < kKeys * DCH; i += kThreads) {
      const int c = i % kKeys;
      const int ch = i / kKeys;
      float f[VEC];
      if (t0 + c < Skv) {
        load16(kb + (t0 + c) * kv_stride + ch * VEC, f);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) f[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) kT[(ch * VEC + j) * kKeys + c] = f[j];
    }
    for (int i = tid; i < kKeys * DCH; i += kThreads) {
      const int ch = i % DCH;
      const int c = i / DCH;
      float f[VEC];
      if (t0 + c < Skv) {
        load16(vb + (t0 + c) * kv_stride + ch * VEC, f);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) f[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; j += 4)
        *reinterpret_cast<float4*>(vS + c * DH + ch * VEC + j) =
            make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
    }
    __syncthreads();

    // ---- scores of rows r0, r0 + 1 against keys t0 + 4tx .. + 3
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float2 qv = *reinterpret_cast<const float2*>(qT + d * kRows + r0);
      const float4 kv = *reinterpret_cast<const float4*>(kT + d * kKeys +
                                                         4 * tx);
      s[0][0] = fmaf(qv.x, kv.x, s[0][0]);
      s[0][1] = fmaf(qv.x, kv.y, s[0][1]);
      s[0][2] = fmaf(qv.x, kv.z, s[0][2]);
      s[0][3] = fmaf(qv.x, kv.w, s[0][3]);
      s[1][0] = fmaf(qv.y, kv.x, s[1][0]);
      s[1][1] = fmaf(qv.y, kv.y, s[1][1]);
      s[1][2] = fmaf(qv.y, kv.z, s[1][2]);
      s[1][3] = fmaf(qv.y, kv.w, s[1][3]);
    }

    // ---- mask, online softmax (the row's 8 threads are lanes 8a..8a+7)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bool vis[4];
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = t0 + 4 * tx + j;
        vis[j] = kp < Skv && qpos[i] < Sq && (!causal || kp <= qpos[i]) &&
                 (window <= 0 || kp > qpos[i] - window);
        s[i][j] = vis[j] ? s[i][j] * scale : kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, o));
      const float m_new = fmaxf(m_run[i], tmax);
      const float alpha = expf(m_run[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        pT[(4 * tx + j) * kRows + r0 + i] = p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        psum += __shfl_xor_sync(kFull, psum, o);
      l_run[i] = l_run[i] * alpha + psum;
      m_run[i] = m_new;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[i][d] *= alpha;
    }
    __syncthreads();

    // ---- acc += P V: this thread's rows, dims 4tx + 32i + {0..3}
#pragma unroll 4
    for (int c = 0; c < kKeys; ++c) {
      const float2 p = *reinterpret_cast<const float2*>(pT + c * kRows + r0);
#pragma unroll
      for (int i = 0; i < DH / 32; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(vS + c * DH +
                                                           32 * i + 4 * tx);
        acc[0][4 * i + 0] = fmaf(p.x, vv.x, acc[0][4 * i + 0]);
        acc[0][4 * i + 1] = fmaf(p.x, vv.y, acc[0][4 * i + 1]);
        acc[0][4 * i + 2] = fmaf(p.x, vv.z, acc[0][4 * i + 2]);
        acc[0][4 * i + 3] = fmaf(p.x, vv.w, acc[0][4 * i + 3]);
        acc[1][4 * i + 0] = fmaf(p.y, vv.x, acc[1][4 * i + 0]);
        acc[1][4 * i + 1] = fmaf(p.y, vv.y, acc[1][4 * i + 1]);
        acc[1][4 * i + 2] = fmaf(p.y, vv.z, acc[1][4 * i + 2]);
        acc[1][4 * i + 3] = fmaf(p.y, vv.w, acc[1][4 * i + 3]);
      }
    }
  }

  // ---- finish: out = acc / max(l, 1e-30) for the rows inside Sq
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + i;
    const int qi = q0 + r / G;
    if (qi >= Sq) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
    if (lse != nullptr && tx == 0)        // one of the row's 8 threads
      lse[((int64_t)blockIdx.x * G + r % G) * Sq + qi] = m_run[i] + logf(l);
    T* orow = ob + qi * q_stride + (r % G) * DH;
#pragma unroll
    for (int ii = 0; ii < DH / 32; ++ii)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store(orow + 32 * ii + 4 * tx + j, acc[i][4 * ii + j] / l);
  }
}


// ---------------------------------------------------------------------------
// bf16: the warp-specialised TMA + wgmma kernel (see the header)
// ---------------------------------------------------------------------------

constexpr int kFaRows = 128;             // score rows a block
constexpr int kFaKeys = 64;              // keys a kv tile
constexpr int kFaThreads = 384;          // producer + 2 consumer warpgroups
constexpr int kRowBytes = 128;           // one swizzled row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DH>
struct FaLayout {
  static constexpr int kBoxes = DH / 64;                       // a row's boxes
  static constexpr int kStages = DH == 256 ? 2 : (DH == 128 ? 3 : 4);
  static constexpr int kQBytes = kBoxes * kFaRows * kRowBytes;  // Q tile
  static constexpr int kTileBytes = kBoxes * kFaKeys * kRowBytes;  // K or V
  // + 1024: the ring starts 1024-aligned, as the swizzle pattern needs
  static constexpr int kSmemBytes = kQBytes + 2 * kStages * kTileBytes + 1024;
};

// (x0, x1) -> bf16x2 hi = round(x) and lo = round(x - hi), x0 in the low
// half (the lower column of a fragment)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// S (64 rows x 64 keys) = Q K^T for one warpgroup, committed and not
// waited for: Q rows from q_rows, K from the tile at ks, both K-major in
// NB boxes of 64 dims
template <int NB>
__device__ __forceinline__ void issue_scores(float (&sc)[32], uint32_t q_rows,
                                             uint32_t ks) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = sw128_desc(q_rows + j * kFaRows * kRowBytes +
                                     32 * kk, 16, 1024);
      const uint64_t db = sw128_desc(ks + j * kFaKeys * kRowBytes + 32 * kk,
                                     16, 1024);
      wgmma_ss_64(sc, da, db, j | kk);
    }
  wgmma_commit();
}

// Mask (edge tiles only) and the online softmax of one 64-key tile of a
// warpgroup's S in log2 units: sc[4j + 2h + e] is row row0 + 8h, key
// t0 + 8j + 2 tig + e, and a row's 64 keys sit in one quad of lanes.  On
// return sc holds p, (m_run, l_run) are updated (l_run is this lane's
// share) and alpha is the factor for the rows' running output.
__device__ __forceinline__ void online_softmax(
    float (&sc)[32], float (&m_run)[2], float (&l_run)[2], float (&alpha)[2],
    int t0, const int (&qpos)[2], int Skv, int causal, int window, int wq0,
    int wq1, float scale_log2, int tig) {
  const bool edge = t0 + kFaKeys > Skv ||
                    (causal && t0 + kFaKeys - 1 > wq0) ||
                    (window > 0 && t0 <= wq1 - window);
#pragma unroll
  for (int e = 0; e < 32; ++e) sc[e] *= scale_log2;
  if (edge) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = t0 + 8 * j + 2 * tig + (e & 1);
        const int qp = qpos[e >> 1];
        const bool vis = kp < Skv && (!causal || kp <= qp) &&
                         (window <= 0 || kp > qp - window);
        if (!vis) sc[4 * j + e] = kNegInf;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      tmax = fmaxf(tmax, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
    tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 2));
    const float m_new = fmaxf(m_run[h], tmax);
    alpha[h] = exp2f(m_run[h] - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * h + e];
        x = x > 0.5f * kNegInf ? exp2f(x - m_new) : 0.f;   // masked -> 0
        psum += x;
      }
    l_run[h] = l_run[h] * alpha[h] + psum;
    m_run[h] = m_new;
  }
}

// kLse: the instance that also writes the log-sum-exp (training); the
// serving instance (kLse false) compiles without that store
template <int DH, int G, bool kLse>
__global__ void __launch_bounds__(kFaThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Skv, int H,
                       int Hk, int causal, int window, float scale_log2) {
  using L = FaLayout<DH>;
  constexpr int BQ = kFaRows / G;          // query positions a block
  constexpr int NB = L::kBoxes;
  constexpr int NS = L::kStages;
  constexpr int kBoxQ = kFaRows * kRowBytes;     // one Q box
  constexpr int kBoxKV = kFaKeys * kRowBytes;    // one K or V box
  static_assert(L::kSmemBytes <= 232448, "shared memory");

  extern __shared__ uint8_t smem_raw[];
  // barriers: Q full, then per stage K full, V full, stage empty
  __shared__ __align__(8) uint64_t bars[1 + 3 * NS];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + L::kQBytes;             // + stage * kTileBytes
  const uint32_t v_s = k_s + NS * L::kTileBytes;
  const uint32_t bar_q = smem_u32(bars);
  auto bar_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_v = [&](int s) { return bar_q + 8u * (1 + NS + s); };
  auto bar_e = [&](int s) { return bar_q + 8u * (1 + 2 * NS + s); };

  // longest first: under causal masking the last q tile sees the most keys
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.y / Hk;
  const int kvh = blockIdx.y % Hk;
  const int q0 = qt * BQ;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(Skv, q_last + 1) : Skv;
  const int t_first = (lo / kFaKeys) * kFaKeys;
  const int n_tiles = hi > t_first ? (hi - t_first + kFaKeys - 1) / kFaKeys
                                   : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_e(s), 2 * 128);        // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int j = 0; j < NB; ++j)
        tma_load_4d(q_s + j * kBoxQ, &q_map, bar_q, 64 * j, kvh * G, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS;
        if (i >= NS) mbar_wait(bar_e(s), ((i / NS) - 1) & 1);
        const int t0 = t_first + i * kFaKeys;
        const uint32_t ks = k_s + s * L::kTileBytes;
        const uint32_t vs = v_s + s * L::kTileBytes;
        mbar_expect_tx(bar_k(s), L::kTileBytes);
        for (int j = 0; j < NB; ++j)
          tma_load_4d(ks + j * kBoxKV, &k_map, bar_k(s), 64 * j, kvh, t0, b);
        mbar_expect_tx(bar_v(s), L::kTileBytes);
        for (int j = 0; j < NB; ++j)
          tma_load_4d(vs + j * kBoxKV, &v_map, bar_v(s), 64 * j, kvh, t0, b);
      }
    }
  } else {
    // ---- consumer warpgroups: rows 64c .. 64c + 63 of the block
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = tid / 128 - 1;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int grp = lane / 4;               // fragment row within 8
    const int tig = lane % 4;               // fragment column pair
    const int row0 = 64 * c + 16 * warp + grp;     // rows row0, row0 + 8
    int qpos[2];
    qpos[0] = q0 + row0 / G;
    qpos[1] = q0 + (row0 + 8) / G;
    // this warpgroup's positions [wq0, wq1]
    const int wq0 = q0 + (64 * c) / G;
    const int wq1 = min(q0 + (64 * c + 63) / G, Sq - 1);

    float o[NB][32];                        // 64-dim column blocks
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[j][e] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};            // this thread's share of l

    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % NS;
      const uint32_t parity = (i / NS) & 1;
      const int t0 = t_first + i * kFaKeys;
      const uint32_t vs = v_s + s * L::kTileBytes;
      mbar_wait(bar_k(s), parity);
      const bool dead = wq0 >= Sq || (causal && t0 > wq1) ||
                        (window > 0 && t0 + kFaKeys - 1 <= wq0 - window);
      if (dead) {             // no row of this warpgroup sees the tile
        mbar_wait(bar_v(s), parity);
        mbar_arrive(bar_e(s));
        continue;
      }

      // ---- S = Q K^T (64 rows x 64 keys), then the online softmax
      float sc[32];
      issue_scores<NB>(sc, q_s + c * 64 * kRowBytes, k_s + s * L::kTileBytes);
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 32; ++e) pin(sc[e]);
      float alpha[2];
      online_softmax(sc, m_run, l_run, alpha, t0, qpos, Skv, causal, window,
                     wq0, wq1, scale_log2, tig);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[j][e] *= alpha[(e >> 1) & 1];

      // ---- P as hi + lo bf16 A fragments: keys 16kk .. 16kk + 15
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        split_bf16(sc[8 * kk + 0], sc[8 * kk + 1], ph[kk][0], pl[kk][0]);
        split_bf16(sc[8 * kk + 2], sc[8 * kk + 3], ph[kk][1], pl[kk][1]);
        split_bf16(sc[8 * kk + 4], sc[8 * kk + 5], ph[kk][2], pl[kk][2]);
        split_bf16(sc[8 * kk + 6], sc[8 * kk + 7], ph[kk][3], pl[kk][3]);
      }

      // ---- O += P V: V's keys 16kk .. 16kk + 15 are 16 swizzled rows;
      // one instruction spans all Dh columns, the boxes being the
      // MN-major atoms kBoxKV bytes apart
      mbar_wait(bar_v(s), parity);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 32; ++e) pin(o[j][e]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = sw128_desc(vs + kk * 16 * kRowBytes, kBoxKV,
                                       1024);
        wgmma_rs<DH>(&o[0][0], ph[kk], dv);
        wgmma_rs<DH>(&o[0][0], pl[kk], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 32; ++e) pin(o[j][e]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pin(ph[kk][e]);
          pin(pl[kk][e]);
        }
      mbar_arrive(bar_e(s));
    }

    // ---- finish: out = o / max(l, 1e-30) for the rows inside Sq
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[h];
      l += __shfl_xor_sync(kFull, l, 1);
      l += __shfl_xor_sync(kFull, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int r = row0 + 8 * h;
      const int qi = q0 + r / G;
      if (qi >= Sq) continue;
      if (kLse && tig == 0)               // m_run is in log2 units
        lse[((int64_t)blockIdx.y * G + r % G) * Sq + qi] =
            m_run[h] * kLn2 + logf(fmaxf(l, 1e-30f));
      __nv_bfloat16* orow =
          out + (((int64_t)b * Sq + qi) * H + (int64_t)kvh * G + r % G) * DH;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int t = 0; t < 8; ++t)
          *reinterpret_cast<__nv_bfloat162*>(orow + 64 * j + 8 * t +
                                             2 * tig) =
              __floats2bfloat162_rn(o[j][4 * t + 2 * h] * inv,
                                    o[j][4 * t + 2 * h + 1] * inv);
    }
  }
}

struct Args {
  const void* q; const void* k; const void* v; void* out; float* lse;
  int B, Sq, Skv, H, Hk, causal, window;
  float scale;
};

// float32: the scalar kernel
template <int DH, int G>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH>() * static_cast<int>(sizeof(float));
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<float, DH, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  constexpr int BQ = kRows / G;
  const dim3 grid(a.B * a.Hk, (a.Sq + BQ - 1) / BQ);
  flash_fwd_kernel<float, DH, G><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lse,
      a.Sq, a.Skv, a.H, a.Hk, a.causal, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16: the TMA + wgmma kernel; the maps are built per launch (host work
// of a few microseconds, no device memory)
template <int DH, int G, bool kLse>
int launch_wgmma(const Args& a, cudaStream_t stream) {
  constexpr int BQ = kFaRows / G;
  CUtensorMap q_map, k_map, v_map;
  int rc = make_map(&q_map, a.q, a.B, a.Sq, a.H, DH, G, BQ);
  if (rc == 0) rc = make_map(&k_map, a.k, a.B, a.Skv, a.Hk, DH, 1, kFaKeys);
  if (rc == 0) rc = make_map(&v_map, a.v, a.B, a.Skv, a.Hk, DH, 1, kFaKeys);
  if (rc != 0) return rc;
  constexpr int bytes = FaLayout<DH>::kSmemBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DH, G, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.Hk);
  flash_fwd_wgmma_kernel<DH, G, kLse><<<grid, kFaThreads, bytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(a.out), a.lse, a.Sq,
      a.Skv, a.H, a.Hk, a.causal, a.window, a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, int G>
int launch_bf16(const Args& a, cudaStream_t stream) {
  return a.lse != nullptr ? launch_wgmma<DH, G, true>(a, stream)
                          : launch_wgmma<DH, G, false>(a, stream);
}

template <bool kBf16, int DH>
int launch_g(int G, const Args& a, cudaStream_t stream) {
  switch (G) {
    case 1: return kBf16 ? launch_bf16<DH, 1>(a, stream)
                         : launch_f32<DH, 1>(a, stream);
    case 2: return kBf16 ? launch_bf16<DH, 2>(a, stream)
                         : launch_f32<DH, 2>(a, stream);
    case 4: return kBf16 ? launch_bf16<DH, 4>(a, stream)
                         : launch_f32<DH, 4>(a, stream);
    case 8: return kBf16 ? launch_bf16<DH, 8>(a, stream)
                         : launch_f32<DH, 8>(a, stream);
    case 16: return kBf16 ? launch_bf16<DH, 16>(a, stream)
                          : launch_f32<DH, 16>(a, stream);
    default: return -1;
  }
}

template <bool kBf16>
int launch_dh(int Dh, int G, const Args& a, cudaStream_t stream) {
  switch (Dh) {
    case 64: return launch_g<kBf16, 64>(G, a, stream);
    case 128: return launch_g<kBf16, 128>(G, a, stream);
    case 256: return launch_g<kBf16, 256>(G, a, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  lse may be null (the serving path:
// nothing more is written); else a (B, Hk, G, Sq) float32 buffer.
// Returns cudaGetLastError() after the
// launch (0 = launched), a cudaFuncSetAttribute error, -1 for a shape or
// dtype this file has no instance of, or -2 when the driver refuses a
// tensor map.  Launches on `stream` and does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int B, int Sq, int Skv, int H, int Hk,
                                   int Dh, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hk <= 0 || H % Hk != 0) return -1;
  const Args a{q, k, v, out, lse, B, Sq, Skv, H, Hk, causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / Hk;
  switch (dtype) {
    case 0: return launch_dh<false>(Dh, G, a, s);
    case 1: return launch_dh<true>(Dh, G, a, s);
    default: return -1;
  }
}
