// Chunked-prefill attention over the page pool, for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// Replaces no TPU kernel: the JAX package's chunk attention is plain jnp
// (src/repro/models/attention.py `chunk_attention`), and so was the port's
// (models/attention.py `chunk_attention` over a gather of the row's whole
// page table).  This kernel computes the same function from the pool in
// place: no gather, and no score matrix in device memory.
//
//   q          (B, C, H, Dh)       bf16 or f32, head h = kv_head * G + g
//   k/v_pages  (P, page, Hk, Dh)   q's dtype
//   page_table (B, max_pages)      int32, clamped to [0, P-1] on use
//   q_pos      (B, C)              int32 absolute positions, < 0 = padded
//   out        (B, C, H, Dh)       q's dtype; float32 accumulation
//
// Semantics of the plain version (the table gathered in position order,
// slot t holding position t, T = max_pages * page slots): query i sees key
// t when t <= q_pos[i]; scores scaled by 1/sqrt(Dh), the finite NEG_INF =
// -1e30 for masked scores, an online softmax in float32, l floored at
// 1e-30.  bf16 rounds P to bf16 before P.V, as both plain versions do; l
// sums the unrounded P.  A padded query (q_pos < 0) sees every key masked,
// so the plain version gives it the mean of V over all T slots of its
// row's table; the kernel writes that value too (score 0 on each of the T
// slots: p = 1, l = T), because a MoE layer routes padded tokens through
// its experts and they take expert capacity, so a real token's result can
// depend on a padded one's.  A tile that holds a padded query therefore
// walks the whole table; a block with no real query loads no K.  Whatever
// a walked slot holds must be finite, as for the plain version (a masked
// score has p = 0, and 0 * NaN is NaN); the engine's pools are.
//
// What bounds it on this card: tensor-core operations.  At yi-9b's
// prefill_heavy chunk (4 rows x 256 queries, 32 heads of 128, offsets
// near 2,048) the products are about 37 GFLOP a layer, 37 us at 989
// TFLOP/s, against 10-20 MB of K and V.  The design follows
// csrc/flash_attention.cu's bf16 kernel, changed for the pool:
//   * a block owns 128 score rows (128 / G positions of one row x the G
//     heads of one kv head), so each K/V tile feeds all G heads; G is a
//     run-time argument (1, 2, 4, 8 or 16: the wrapper regroups any
//     other), Dh a template one (64, 128, 256);
//   * one producer thread issues TMA loads: the Q tile once, then K and V
//     tiles of 64 keys into a ring of 4 / 3 / 2 stages (Dh 64 / 128 / 256)
//     with mbarrier full / empty pairs.  A tile is cut into boxes of
//     min(page, 64) rows, each one TMA load from a rank-4 map over the
//     pool (Dh, Hk, page, P), at the page id the block read into shared
//     memory once (clamped to the pool); the 128-byte swizzle repeats
//     every 8 rows, so the boxes land as one 64-row tile would;
//   * two consumer warpgroups of 64 rows each run S = Q K^T and O += P V
//     on wgmma (m64n64k16 from shared memory; m64n{Dh}k16 with P from
//     registers, rounded once to bf16), with an online softmax on the S
//     accumulator;
//   * the block walks key tiles only up to the largest position among its
//     queries (the whole table when it holds a padded query).  A tile
//     wholly at or below every query's position runs unmasked; only the
//     tiles on the chunk's diagonal are masked, and a warpgroup skips the
//     tiles past all of its rows;
//   * no workspace and no split-KV: nothing for a captured graph to pin;
//     blocks are launched last query tile first, the tiles that see the
//     most keys.
// float32 (the parity runs; no tensor-core path keeps its precision) runs
// scalar FMAs, as the flash kernel's float32 path does: 64 score rows a
// block, key tiles of 32 read through the table row by row.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

#include "hopper.cuh"

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAbsent = INT_MIN;          // a block row past C
constexpr int kMaxTablePages = 4096;      // the wrapper's MAX_TABLE_PAGES

__device__ __forceinline__ int log2_of(int g) { return 31 - __clz(g); }

// The block's query positions into pos_s (kAbsent past C), then its
// extent over the two halves of its rows: mx[h] the largest real position
// (-1 if none), mn[h] the smallest (INT_MAX if none), pad[h] whether a
// padded query is among them.  Warp 0 reduces; everyone reads stat_s.
__device__ __forceinline__ void block_positions(const int* __restrict__ q_pos,
                                                int* pos_s, int* stat_s,
                                                int b, int q0, int bq, int C,
                                                int tid) {
  for (int i = tid; i < bq; i += blockDim.x)
    pos_s[i] = q0 + i < C ? q_pos[(int64_t)b * C + q0 + i] : kAbsent;
  __syncthreads();
  if (tid < 32) {
    int mx[2] = {-1, -1}, mn[2] = {INT_MAX, INT_MAX}, pad[2] = {0, 0};
    for (int i = tid; i < bq; i += 32) {
      const int p = pos_s[i];
      const int h = i >= bq / 2;
      if (p == kAbsent) continue;
      if (p >= 0) {
        mx[h] = max(mx[h], p);
        mn[h] = min(mn[h], p);
      } else {
        pad[h] = 1;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mx[h] = max(mx[h], __shfl_xor_sync(kFull, mx[h], o));
        mn[h] = min(mn[h], __shfl_xor_sync(kFull, mn[h], o));
        pad[h] |= __shfl_xor_sync(kFull, pad[h], o);
      }
    if (tid == 0) {
      stat_s[0] = mx[0]; stat_s[1] = mn[0]; stat_s[2] = pad[0];
      stat_s[3] = mx[1]; stat_s[4] = mn[1]; stat_s[5] = pad[1];
    }
  }
  __syncthreads();
}

// keys [0, hi) that rows with largest real position mx and padded queries
// (pad) need, in a table of T slots
__device__ __forceinline__ int extent(int mx, int pad, int T) {
  return pad ? T : min(mx + 1, T);
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kRows = 64;        // score rows per block: (64 / G) positions x G
constexpr int kKeys = 32;        // keys per kv tile

template <int DH>
constexpr int smem_floats() {
  return DH * kRows + DH * kKeys + kKeys * DH + kKeys * kRows;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
chunk_attention_f32(const float* __restrict__ q, const float* __restrict__ kp,
                    const float* __restrict__ vp, const int* __restrict__ pt,
                    const int* __restrict__ q_pos, float* __restrict__ out,
                    int C, int H, int Hk, int G, int n_pool, int page,
                    int max_pages, float scale) {
  constexpr int DCH = DH / 4;             // 16-byte chunks per head row
  constexpr int DPT = DH / 8;             // output dims per thread and row
  const int lg = log2_of(G);
  const int bq = kRows >> lg;             // query positions per block

  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);   // [DH][kRows]
  float* kT = qT + DH * kRows;                    // [DH][kKeys]
  float* vS = kT + DH * kKeys;                    // [kKeys][DH]
  float* pT = vS + kKeys * DH;                    // [kKeys][kRows]
  __shared__ int pos_s[kRows];
  __shared__ int stat_s[6];
  __shared__ int64_t row_s[kKeys];        // a tile key's pool row, or -1

  const int b = blockIdx.y / Hk;
  const int kvh = blockIdx.y % Hk;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;
  const int tid = threadIdx.x;
  const int tx = tid % 8;                 // keys 4tx.. / dims 4tx + 32i..
  const int r0 = 2 * (tid / 8);           // this thread's rows r0, r0 + 1
  const int T = max_pages * page;

  block_positions(q_pos, pos_s, stat_s, b, q0, bq, C, tid);
  const int hi = extent(max(stat_s[0], stat_s[3]), stat_s[2] | stat_s[5], T);

  const int64_t q_stride = (int64_t)H * DH;      // position to position
  const float* qb = q + (int64_t)b * C * q_stride + (int64_t)kvh * G * DH;
  float* ob = out + (int64_t)b * C * q_stride + (int64_t)kvh * G * DH;
  const int* ptb = pt + (int64_t)b * max_pages;

  // ---- the Q tile, transposed: row r is (position q0 + r / G, head r % G)
  for (int i = tid; i < kRows * DCH; i += kThreads) {
    const int r = i % kRows;
    const int ch = i / kRows;
    const int qi = q0 + (r >> lg);
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < C)
      f = *reinterpret_cast<const float4*>(qb + qi * q_stride +
                                           (r & (G - 1)) * DH + ch * 4);
    qT[(ch * 4 + 0) * kRows + r] = f.x;
    qT[(ch * 4 + 1) * kRows + r] = f.y;
    qT[(ch * 4 + 2) * kRows + r] = f.z;
    qT[(ch * 4 + 3) * kRows + r] = f.w;
  }

  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = pos_s[(r0 + i) >> lg];

  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  float acc[2][DPT];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[i][d] = 0.f;

  for (int t0 = 0; t0 < hi; t0 += kKeys) {
    __syncthreads();    // the previous tile's reads (and the Q tile) done
    if (tid < kKeys) {
      const int t = t0 + tid;
      int64_t row = -1;
      if (t < T) {
        const int id = min(max(ptb[t / page], 0), n_pool - 1);
        row = ((int64_t)id * page + t % page) * Hk + kvh;
      }
      row_s[tid] = row;
    }
    __syncthreads();

    // ---- K tile, transposed, and V tile; slots past the table are zeros
    for (int i = tid; i < kKeys * DCH; i += kThreads) {
      const int c = i % kKeys;
      const int ch = i / kKeys;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row_s[c] >= 0)
        f = *reinterpret_cast<const float4*>(kp + row_s[c] * DH + ch * 4);
      kT[(ch * 4 + 0) * kKeys + c] = f.x;
      kT[(ch * 4 + 1) * kKeys + c] = f.y;
      kT[(ch * 4 + 2) * kKeys + c] = f.z;
      kT[(ch * 4 + 3) * kKeys + c] = f.w;
    }
    for (int i = tid; i < kKeys * DCH; i += kThreads) {
      const int ch = i % DCH;
      const int c = i / DCH;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row_s[c] >= 0)
        f = *reinterpret_cast<const float4*>(vp + row_s[c] * DH + ch * 4);
      *reinterpret_cast<float4*>(vS + c * DH + ch * 4) = f;
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

    // ---- mask, online softmax (the row's 8 threads are lanes 8a..8a+7);
    // a padded (or absent) row scores 0 on every slot of the table
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bool vis[4];
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + 4 * tx + j;
        const bool real = qpos[i] >= 0;
        vis[j] = t < T && (!real || t <= qpos[i]);
        s[i][j] = !vis[j] ? kNegInf : (real ? s[i][j] * scale : 0.f);
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

  // ---- finish: out = acc / max(l, 1e-30) for the rows inside C
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + i;
    const int qi = q0 + (r >> lg);
    if (qi >= C) continue;
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
    float* orow = ob + qi * q_stride + (r & (G - 1)) * DH;
#pragma unroll
    for (int ii = 0; ii < DH / 32; ++ii)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        orow[32 * ii + 4 * tx + j] = acc[i][4 * ii + j] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16: the warp-specialised TMA + wgmma kernel (see the header)
// ---------------------------------------------------------------------------

constexpr int kBRows = 128;              // score rows a block
constexpr int kBKeys = 64;               // keys a kv tile
constexpr int kBThreads = 384;           // producer + 2 consumer warpgroups
constexpr int kRowBytes = 128;           // one swizzled row: 64 bf16

template <int DH>
struct Layout {
  static constexpr int kBoxes = DH / 64;                       // a row's boxes
  static constexpr int kStages = DH == 256 ? 2 : (DH == 128 ? 3 : 4);
  static constexpr int kQBytes = kBoxes * kBRows * kRowBytes;  // Q tile
  static constexpr int kTileBytes = kBoxes * kBKeys * kRowBytes;  // K or V
  // + 1024: the ring starts 1024-aligned, as the swizzle pattern needs;
  // the table's page ids follow the ring
  static constexpr int kRingBytes = kQBytes + 2 * kStages * kTileBytes + 1024;
};

// (x0, x1) -> bf16x2, each rounded to nearest, x0 in the low half (the
// lower column of a fragment)
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
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
      const uint64_t da = sw128_desc(q_rows + j * kBRows * kRowBytes +
                                     32 * kk, 16, 1024);
      const uint64_t db = sw128_desc(ks + j * kBKeys * kRowBytes + 32 * kk,
                                     16, 1024);
      wgmma_ss_64(sc, da, db, j | kk);
    }
  wgmma_commit();
}

// Mask (edge tiles only) and the online softmax of one 64-key tile of a
// warpgroup's S in log2 units: sc[4j + 2h + e] is row row0 + 8h, key
// t0 + 8j + 2 tig + e, and a row's 64 keys sit in one quad of lanes.  A
// real row sees keys t <= its position; a padded (or absent) row scores 0
// on every slot t < T.  On return sc holds p, (m_run, l_run) are updated
// (l_run is this lane's share) and alpha is the factor for the rows'
// running output.
__device__ __forceinline__ void online_softmax(
    float (&sc)[32], float (&m_run)[2], float (&l_run)[2], float (&alpha)[2],
    int t0, const int (&qpos)[2], int T, bool edge, float scale_log2,
    int tig) {
#pragma unroll
  for (int e = 0; e < 32; ++e) sc[e] *= scale_log2;
  if (edge) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + 8 * j + 2 * tig + (e & 1);
        const int qp = qpos[e >> 1];
        float& x = sc[4 * j + e];
        if (t >= T || (qp >= 0 && t > qp)) x = kNegInf;
        else if (qp < 0) x = 0.f;
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

template <int DH>
__global__ void __launch_bounds__(kBThreads, 1)
chunk_attention_wgmma(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const int* __restrict__ pt,
                      const int* __restrict__ q_pos,
                      __nv_bfloat16* __restrict__ out, int C, int H, int Hk,
                      int G, int n_pool, int page, int max_pages,
                      float scale_log2) {
  using L = Layout<DH>;
  constexpr int NB = L::kBoxes;
  constexpr int NS = L::kStages;
  constexpr int kBoxQ = kBRows * kRowBytes;      // one Q box
  constexpr int kBoxKV = kBKeys * kRowBytes;     // one K or V box
  static_assert(L::kRingBytes + kMaxTablePages * 4 <= 232448,
                "shared memory");

  extern __shared__ uint8_t smem_raw[];
  // barriers: Q full, then per stage K full, V full, stage empty
  __shared__ __align__(8) uint64_t bars[1 + 3 * NS];
  __shared__ int pos_s[kBRows];
  __shared__ int stat_s[6];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + L::kQBytes;             // + stage * kTileBytes
  const uint32_t v_s = k_s + NS * L::kTileBytes;
  int* ids_s = reinterpret_cast<int*>(smem_raw + (base - smem_u32(smem_raw)) +
                                      L::kQBytes + 2 * NS * L::kTileBytes);
  const uint32_t bar_q = smem_u32(bars);
  auto bar_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_v = [&](int s) { return bar_q + 8u * (1 + NS + s); };
  auto bar_e = [&](int s) { return bar_q + 8u * (1 + 2 * NS + s); };

  const int lg = log2_of(G);
  const int bq = kBRows >> lg;             // query positions a block
  // last query tile first: the later positions of a chunk see more keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;
  const int b = blockIdx.y / Hk;
  const int kvh = blockIdx.y % Hk;
  const int T = max_pages * page;
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
  block_positions(q_pos, pos_s, stat_s, b, q0, bq, C, tid);
  const bool any_real = max(stat_s[0], stat_s[3]) >= 0;
  const int hi = extent(max(stat_s[0], stat_s[3]), stat_s[2] | stat_s[5], T);
  const int n_tiles = (hi + kBKeys - 1) / kBKeys;
  // the page ids the walk reads, clamped to the pool
  const int n_ids = min(max_pages, (hi + page - 1) / page);
  for (int i = tid; i < n_ids; i += kBThreads)
    ids_s[i] = min(max(pt[(int64_t)b * max_pages + i], 0), n_pool - 1);
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int j = 0; j < NB; ++j)
        tma_load_4d(q_s + j * kBoxQ, &q_map, bar_q, 64 * j, kvh * G, q0, b);
      // a tile is 64 / rows boxes of `rows` keys a 64-dim column
      const int rows = min(page, kBKeys);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS;
        if (i >= NS) mbar_wait(bar_e(s), ((i / NS) - 1) & 1);
        const int t0 = i * kBKeys;
        for (int kv = any_real ? 0 : 1; kv < 2; ++kv) {
          const uint32_t dst = (kv ? v_s : k_s) + s * L::kTileBytes;
          const uint32_t bar = kv ? bar_v(s) : bar_k(s);
          const CUtensorMap* map = kv ? &v_map : &k_map;
          mbar_expect_tx(bar, L::kTileBytes);
          for (int r = 0; r < kBKeys; r += rows) {
            const int t = t0 + r;     // past the walk: any read page, masked
            const int id = ids_s[min(t / page, n_ids - 1)];
            for (int j = 0; j < NB; ++j)
              tma_load_4d(dst + j * kBoxKV + r * kRowBytes, map, bar, 64 * j,
                          kvh, t % page, id);
          }
        }
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
    qpos[0] = pos_s[row0 >> lg];
    qpos[1] = pos_s[(row0 + 8) >> lg];
    // this warpgroup's real positions [w_min, w_max], padded queries, and
    // the keys its rows need
    const int w_max = stat_s[3 * c];
    const int w_min = stat_s[3 * c + 1];
    const int w_pad = stat_s[3 * c + 2];
    const bool w_real = w_max >= 0;
    const int w_hi = w_real || w_pad ? extent(w_max, w_pad, T) : 0;

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
      const int t0 = i * kBKeys;
      const uint32_t vs = v_s + s * L::kTileBytes;
      if (any_real) mbar_wait(bar_k(s), parity);
      if (t0 >= w_hi) {       // no row of this warpgroup needs the tile
        mbar_wait(bar_v(s), parity);
        mbar_arrive(bar_e(s));
        continue;
      }

      // ---- S = Q K^T (64 rows x 64 keys), then the online softmax; a
      // warpgroup of padded queries alone scores nothing
      float sc[32];
      if (w_real) {
        issue_scores<NB>(sc, q_s + c * 64 * kRowBytes,
                         k_s + s * L::kTileBytes);
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 32; ++e) pin(sc[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      }
      const bool edge = w_pad || t0 + kBKeys > T ||
                        (w_real && t0 + kBKeys - 1 > w_min);
      float alpha[2];
      online_softmax(sc, m_run, l_run, alpha, t0, qpos, T, edge, scale_log2,
                     tig);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[j][e] *= alpha[(e >> 1) & 1];

      // ---- P rounded to bf16, as A fragments: keys 16kk .. 16kk + 15
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);

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
        wgmma_rs<DH>(&o[0][0], pa[kk], dv);
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
        for (int e = 0; e < 4; ++e) pin(pa[kk][e]);
      mbar_arrive(bar_e(s));
    }

    // ---- finish: out = o / max(l, 1e-30) for the rows inside C
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[h];
      l += __shfl_xor_sync(kFull, l, 1);
      l += __shfl_xor_sync(kFull, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int r = row0 + 8 * h;
      const int qi = q0 + (r >> lg);
      if (qi >= C) continue;
      __nv_bfloat16* orow =
          out + (((int64_t)b * C + qi) * H + (int64_t)kvh * G +
                 (r & (G - 1))) * DH;
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
  const void* q; const void* k; const void* v; const int* pt;
  const int* q_pos; void* out;
  int B, C, H, Hk, G, n_pool, page, max_pages;
  float scale;
};

template <int DH>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH>() * static_cast<int>(sizeof(float));
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chunk_attention_f32<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int bq = kRows / a.G;
  const dim3 grid((a.C + bq - 1) / bq, a.B * a.Hk);
  chunk_attention_f32<DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.pt, a.q_pos,
      static_cast<float*>(a.out), a.C, a.H, a.Hk, a.G, a.n_pool, a.page,
      a.max_pages, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16: the TMA + wgmma kernel; the maps are built per launch (host work
// of a few microseconds, no device memory): Q over (B, C, H, Dh) in boxes
// of the block's G heads x 128 / G positions, the pools over (P, page,
// Hk, Dh) in boxes of one head x min(page, 64) rows of a page
template <int DH>
int launch_wgmma(const Args& a, cudaStream_t stream) {
  const int bq = kBRows / a.G;
  CUtensorMap q_map, k_map, v_map;
  const int rows = a.page < kBKeys ? a.page : kBKeys;
  int rc = make_map(&q_map, a.q, a.B, a.C, a.H, DH, a.G, bq);
  if (rc == 0) rc = make_map(&k_map, a.k, a.n_pool, a.page, a.Hk, DH, 1, rows);
  if (rc == 0) rc = make_map(&v_map, a.v, a.n_pool, a.page, a.Hk, DH, 1, rows);
  if (rc != 0) return rc;
  const int bytes = Layout<DH>::kRingBytes + a.max_pages * 4;
  const cudaError_t e = cudaFuncSetAttribute(
      chunk_attention_wgmma<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.C + bq - 1) / bq, a.B * a.Hk);
  chunk_attention_wgmma<DH><<<grid, kBThreads, bytes, stream>>>(
      q_map, k_map, v_map, a.pt, a.q_pos,
      static_cast<__nv_bfloat16*>(a.out), a.C, a.H, a.Hk, a.G, a.n_pool,
      a.page, a.max_pages, a.scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int launch_dh(int Dh, const Args& a, cudaStream_t stream) {
  switch (Dh) {
    case 64: return kBf16 ? launch_wgmma<64>(a, stream)
                          : launch_f32<64>(a, stream);
    case 128: return kBf16 ? launch_wgmma<128>(a, stream)
                           : launch_f32<128>(a, stream);
    case 256: return kBf16 ? launch_wgmma<256>(a, stream)
                           : launch_f32<256>(a, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  G = H / Hk must be 1, 2, 4, 8 or 16,
// page a multiple of 8 that is at most 64 or a multiple of 64, and
// max_pages at most 4096; window must be 0 (no paged layer has one).
// Returns cudaGetLastError() after the launch (0 = launched), a
// cudaFuncSetAttribute error, -1 for a shape or dtype this file has no
// instance of, or -2 when the driver refuses a tensor map.  Launches on
// `stream` and does not synchronise.
extern "C" int paged_chunk_attention(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const int* page_table, const int* q_pos,
                                     void* out, int B, int C, int H, int Hk,
                                     int Dh, int n_pool, int page,
                                     int max_pages, int window, float scale,
                                     int dtype, void* stream) {
  if (B <= 0 || C <= 0 || Hk <= 0 || H % Hk != 0 || n_pool <= 0 ||
      max_pages <= 0 || max_pages > kMaxTablePages || window != 0)
    return -1;
  if (page < 8 || page % 8 != 0 || (page > kBKeys && page % kBKeys != 0))
    return -1;
  const int G = H / Hk;
  if (G != 1 && G != 2 && G != 4 && G != 8 && G != 16) return -1;
  const Args a{q, k_pages, v_pages, page_table, q_pos, out, B, C, H, Hk, G,
               n_pool, page, max_pages, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dh<false>(Dh, a, s);
    case 1: return launch_dh<true>(Dh, a, s);
    default: return -1;
  }
}
