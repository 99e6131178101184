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
// is far above the card's ~295 flops per byte.  Common to both paths:
//   * one block per (batch row, kv head, tile of 64 / G query positions):
//     the G query heads of a kv head are folded into the block's 64 score
//     rows, so one load of each K/V tile serves all G heads (GQA reuse).
//     G is 1, 2, 4, 8 or 16; at G = 16 (recurrentgemma's local layers, 16
//     heads over one kv head) a block holds 4 positions.  Every row maps to
//     its own (position, head) by r / G and r % G, and no tile size depends
//     on 64 / G, so the small position tile needs nothing else;
//   * the block loops over kv tiles from the first tile inside the window
//     to the last tile at or below the diagonal, skipping whole tiles
//     outside the span as the TPU kernel's pl.when(live) does;
//   * tiles sit in dynamic shared memory (above 48 KB at Dh = 256, opted
//     in with cudaFuncSetAttribute).
// bf16 runs both products on the tensor cores (mma.sync m16n8k16, float32
// accumulation) in FlashAttention-2's register layout: 4 warps of 16 rows,
// kv tiles of 64 keys, P kept in registers between the two products.
// float32 has no tensor-core path that keeps its precision (TF32 would
// round the inputs), so it runs scalar float32 FMAs: kv tiles of 32 keys,
// Q, K (transposed), V and P in shared memory as float32, each thread
// owning 2 rows x 4 keys of the scores and the same 2 rows x Dh/8 dims of
// the output, so every shared-memory load feeds 8 FMAs.
// Not yet done (later work): overlapping the tile loads with the products
// (cp.async or TMA, then wgmma), and splitting long rows across blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(h[j]);
    f[2 * j] = x.x; f[2 * j + 1] = x.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int DH>
constexpr int smem_floats() {
  return DH * kRows + DH * kKeys + kKeys * DH + kKeys * kRows;
}

template <typename T, int DH, int G>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Sq,
                 int Skv, int H, int Hk, int causal, int window,
                 float scale) {
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
    T* orow = ob + qi * q_stride + (r % G) * DH;
#pragma unroll
    for (int ii = 0; ii < DH / 32; ++ii)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store(orow + 32 * ii + 4 * tx + j, acc[i][4 * ii + j] / l);
  }
}

// ---------------------------------------------------------------------------
// bf16: the two products on the tensor cores (mma.sync m16n8k16, float32
// accumulation), FlashAttention-2's register layout.  4 warps, each owning
// 16 of the block's 64 score rows; kv tiles of 64 keys.  Q, K and V tiles
// sit in shared memory as bf16, rows padded by 16 bytes so that the 8 row
// addresses of an ldmatrix fall in distinct banks.  P enters the P.V
// product as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), so that it
// keeps 16 bits of mantissa (error below 2**-17 of p) and the output stays
// within one bf16 ulp of the float32 plain version; the TPU kernel instead
// rounds P once to bf16 (p.astype(v.dtype)).  The second product costs
// tensor-core time the kernel has to spare.
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaKeys = 64;             // keys per kv tile

template <int DH>
__host__ __device__ constexpr int mma_pitch() { return DH + 8; }  // bf16 a row

template <int DH>
constexpr int mma_smem_bytes() {
  return (kRows + 2 * kMmaKeys) * mma_pitch<DH>() * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) -> bf16x2 hi = round(x) and lo = round(x - hi), x0 in the low
// half (the lower column of an mma fragment)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int DH, int G>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H,
                     int Hk, int causal, int window, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int BQ = kRows / G;
  constexpr int P = mma_pitch<DH>();
  constexpr int CH = DH / 8;              // 16-byte chunks a head row
  constexpr int NT = DH / 8;              // 8-wide output tiles a row
  constexpr int kThreadsMma = kMmaWarps * 32;
  static_assert(kRows == 16 * kMmaWarps, "16 score rows a warp");

  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);      // [kRows][P]
  bf16* ks = qs + kRows * P;                      // [kMmaKeys][P]
  bf16* vs = ks + kMmaKeys * P;                   // [kMmaKeys][P]

  const int b = blockIdx.x / Hk;
  const int kvh = blockIdx.x % Hk;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane / 4;               // fragment row within 8
  const int tig = lane % 4;               // fragment column pair

  const int64_t q_stride = (int64_t)H * DH;
  const int64_t kv_stride = (int64_t)Hk * DH;
  const bf16* qb = q + (int64_t)b * Sq * q_stride + (int64_t)kvh * G * DH;
  const bf16* kb = k + (int64_t)b * Skv * kv_stride + (int64_t)kvh * DH;
  const bf16* vb = v + (int64_t)b * Skv * kv_stride + (int64_t)kvh * DH;
  bf16* ob = out + (int64_t)b * Sq * q_stride + (int64_t)kvh * G * DH;

  // ---- the Q tile: row r is (position q0 + r / G, head r % G)
  for (int i = tid; i < kRows * CH; i += kThreadsMma) {
    const int r = i / CH;
    const int ch = i % CH;
    const int qi = q0 + r / G;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (qi < Sq)
      val = *reinterpret_cast<const uint4*>(qb + qi * q_stride +
                                            (r % G) * DH + ch * 8);
    *reinterpret_cast<uint4*>(qs + r * P + ch * 8) = val;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(Skv, q_last + 1) : Skv;
  const int row0 = 16 * warp + grp;       // this thread's rows row0, row0 + 8
  int qpos[2];
  qpos[0] = q0 + row0 / G;
  qpos[1] = q0 + (row0 + 8) / G;

  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;

  // ldmatrix row addresses: lane l feeds row (l % 8) of matrix (l / 8)
  const int lm_row = lane % 8;
  const int lm_mat = lane / 8;

  for (int t0 = (lo / kMmaKeys) * kMmaKeys; t0 < hi; t0 += kMmaKeys) {
    __syncthreads();    // the previous tile's reads (and the Q tile) done
    for (int i = tid; i < kMmaKeys * CH; i += kThreadsMma) {
      const int c = i / CH;
      const int ch = i % CH;
      uint4 kval = make_uint4(0, 0, 0, 0);
      uint4 vval = make_uint4(0, 0, 0, 0);
      if (t0 + c < Skv) {
        kval = *reinterpret_cast<const uint4*>(kb + (t0 + c) * kv_stride +
                                               ch * 8);
        vval = *reinterpret_cast<const uint4*>(vb + (t0 + c) * kv_stride +
                                               ch * 8);
      }
      *reinterpret_cast<uint4*>(ks + c * P + ch * 8) = kval;
      *reinterpret_cast<uint4*>(vs + c * P + ch * 8) = vval;
    }
    __syncthreads();

    // ---- S = Q K^T: this warp's 16 rows x 64 keys, 8 tiles of 8 keys
    float s[kMmaKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kMmaKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];
      // matrices: rows 0-7 / 8-15 of the warp x d 0-7 / 8-15 of the step
      ldmatrix_x4(a, qs + (16 * warp + lm_row + (lm_mat % 2) * 8) * P +
                         16 * kk + (lm_mat / 2) * 8);
#pragma unroll
      for (int j2 = 0; j2 < kMmaKeys / 16; ++j2) {
        uint32_t bfr[4];
        // matrices: keys 0-7 / 8-15 of the pair x d 0-7 / 8-15
        ldmatrix_x4(bfr, ks + (16 * j2 + lm_row + (lm_mat / 2) * 8) * P +
                             16 * kk + (lm_mat % 2) * 8);
        mma_bf16(s[2 * j2], a, bfr[0], bfr[1]);
        mma_bf16(s[2 * j2 + 1], a, bfr[2], bfr[3]);
      }
    }

    // ---- mask, online softmax; a row's 4 threads are one quad of lanes
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kMmaKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = t0 + 8 * j + 2 * tig + e;
          const bool vis = kp < Skv && qpos[h] < Sq &&
                           (!causal || kp <= qpos[h]) &&
                           (window <= 0 || kp > qpos[h] - window);
          float& x = s[j][2 * h + e];
          x = vis ? x * scale : kNegInf;
          tmax = fmaxf(tmax, x);
        }
      tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 2));
      const float m_new = fmaxf(m_run[h], tmax);
      alpha[h] = expf(m_run[h] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kMmaKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * h + e];
          x = x > 0.5f * kNegInf ? expf(x - m_new) : 0.f;   // masked -> 0
          psum += x;
        }
      psum += __shfl_xor_sync(kFull, psum, 1);
      psum += __shfl_xor_sync(kFull, psum, 2);
      l_run[h] = l_run[h] * alpha[h] + psum;
      m_run[h] = m_new;
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      o[t][0] *= alpha[0];
      o[t][1] *= alpha[0];
      o[t][2] *= alpha[1];
      o[t][3] *= alpha[1];
    }

    // ---- O += P V: P (hi + lo) from the score registers, whose layout
    // is the A fragment's; V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      uint32_t ah[4], al[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int t2 = 0; t2 < NT / 2; ++t2) {
        uint32_t bfr[4];
        // matrices: keys 0-7 / 8-15 of the step x d 0-7 / 8-15 of the pair
        ldmatrix_x4_trans(bfr, vs + (16 * kk + lm_row + (lm_mat % 2) * 8) *
                                       P + 16 * t2 + (lm_mat / 2) * 8);
        mma_bf16(o[2 * t2], ah, bfr[0], bfr[1]);
        mma_bf16(o[2 * t2], al, bfr[0], bfr[1]);
        mma_bf16(o[2 * t2 + 1], ah, bfr[2], bfr[3]);
        mma_bf16(o[2 * t2 + 1], al, bfr[2], bfr[3]);
      }
    }
  }

  // ---- finish: out = o / max(l, 1e-30) for the rows inside Sq
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    const int qi = q0 + r / G;
    if (qi >= Sq) continue;
    const float l = fmaxf(l_run[h], 1e-30f);
    bf16* orow = ob + qi * q_stride + (r % G) * DH;
#pragma unroll
    for (int t = 0; t < NT; ++t)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * t + 2 * tig) =
          __floats2bfloat162_rn(o[t][2 * h] / l, o[t][2 * h + 1] / l);
  }
}

struct Args {
  const void* q; const void* k; const void* v; void* out;
  int B, Sq, Skv, H, Hk, causal, window;
  float scale;
};

// float32: the scalar kernel; bf16: the tensor-core kernel
template <typename T, int DH, int G>
int launch(const Args& a, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int bytes =
      kMma ? mma_smem_bytes<DH>()
           : smem_floats<DH>() * static_cast<int>(sizeof(float));
  const void* fn = kMma
      ? reinterpret_cast<const void*>(flash_fwd_mma_kernel<DH, G>)
      : reinterpret_cast<const void*>(flash_fwd_kernel<T, DH, G>);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  constexpr int BQ = kRows / G;
  const dim3 grid(a.B * a.Hk, (a.Sq + BQ - 1) / BQ);
  if constexpr (kMma) {
    flash_fwd_mma_kernel<DH, G><<<grid, kMmaWarps * 32, bytes, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.out), a.Sq, a.Skv,
        a.H, a.Hk, a.causal, a.window, a.scale);
  } else {
    flash_fwd_kernel<T, DH, G><<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.out), a.Sq, a.Skv,
        a.H, a.Hk, a.causal, a.window, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_g(int G, const Args& a, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, DH, 1>(a, stream);
    case 2: return launch<T, DH, 2>(a, stream);
    case 4: return launch<T, DH, 4>(a, stream);
    case 8: return launch<T, DH, 8>(a, stream);
    case 16: return launch<T, DH, 16>(a, stream);
    default: return -1;
  }
}

template <typename T>
int launch_dh(int Dh, int G, const Args& a, cudaStream_t stream) {
  switch (Dh) {
    case 64: return launch_g<T, 64>(G, a, stream);
    case 128: return launch_g<T, 128>(G, a, stream);
    case 256: return launch_g<T, 256>(G, a, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched), a cudaFuncSetAttribute error, or -1 for a shape
// or dtype this file has no instance of.  Launches on `stream` and does
// not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Skv, int H, int Hk, int Dh, int causal,
                                   int window, float scale, int dtype,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hk <= 0 || H % Hk != 0) return -1;
  const Args a{q, k, v, out, B, Sq, Skv, H, Hk, causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / Hk;
  switch (dtype) {
    case 0: return launch_dh<float>(Dh, G, a, s);
    case 1: return launch_dh<__nv_bfloat16>(Dh, G, a, s);
    default: return -1;
  }
}
