// Paged decode attention for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (`paged_decode_attention`, kernel body `_paged_kernel`): one-token GQA
// decode attention over a shared page pool.  It computes what that kernel
// computes, not how: the TPU grid's sequential walk over blocks of pages
// becomes blocks that each walk one split of a row's pages, and a merge.
//
//   q          (B, H, Dh)          bf16 or f32, head h = kv_head * G + g
//   k/v_pages  (P, page, Hk, Dh)   same dtype as q
//   page_table (B, max_pages)      int32, clamped to [0, P-1] on use
//   seq_lens   (B,)                int32, tokens present per row
//   out        (B, H, Dh)          q's dtype; float32 accumulation
//
// Semantics kept from the TPU kernel: scores scaled by 1/sqrt(Dh), finite
// NEG_INF = -1e30 for masked scores, online softmax, l floored at 1e-30,
// optional sliding window (only tokens >= seq_len - window count).  A row
// reads only the table slots that hold its tokens [lo, seq_len) — with a
// window it starts at the page of its first in-window token — so it never
// touches another request's pages.  A seq_len == 0 row reads nothing and
// writes exact zeros (0 / max(0, 1e-30)).
//
// What bounds it on this card: memory.  Each (b, kv-head) must read its
// K and V rows once: sum_b seq_len_b * Hk * Dh * 2 (K and V) * 2 bytes in
// bf16, over the H100's 3.35 TB/s.  The arithmetic is 4 * G * Dh flops
// per token and kv head, 2 * G flops per byte read: far below the ~295
// flops per byte at which the tensor cores would be the limit, but at
// G = 8 it is 16 flops a byte, 54 TFLOP/s at the memory rate, close to the
// card's 67 TFLOP/s of float32 FMAs.  So:
//   * split-KV: each (b, kv-head) pair is cut into n_split splits of whole
//     pages (pages_per_split, chosen by the wrapper's split_plan from the
//     table width and the SM count so that a decode batch puts several
//     blocks on every SM); the grid is (B * Hk, n_split), and a split
//     reads only its own pages that hold tokens of [lo, seq_len).  It
//     writes a float32 partial (m, l, o) per head to a workspace (an empty
//     split writes m = NEG_INF, l = 0, o = 0);
//   * the merge runs in the same launch: each split takes a ticket from a
//     per-pair atomic counter after its partial is visible, and the split
//     that draws the last ticket merges the pair's partials, writes the
//     output in q's dtype and resets the counter to 0 for the next launch.
//     One launch, not two: a second launch would cost a few microseconds
//     against a bound of about 12 at yi-9b's decode shape, and keeps the
//     step graph-capturable all the same;
//   * bf16: K and V tiles of 16 tokens a warp (64 tokens a tile at Dh <=
//     128 with 4 warps, 32 with 2 warps at Dh = 256) are copied with
//     cp.async (16 bytes a thread, zero-filled past the split) into a
//     3-stage ring in shared memory, so two tiles are in flight while one
//     is scored; the split's page ids, clamped, are read into shared
//     memory once, so that no copy waits on a table read.  Both products
//     run on the tensor cores with mma.sync m16n8k16 and float32
//     accumulation, keys on the M side and the <= 8
//     heads of a group on N = 8 (G < 8 pads N with zero queries):
//       scores  S^T (16 keys x 8 heads) = K tile . q^T, q in registers;
//       output  O^T (Dh x 8) += V^T . P^T, V^T through ldmatrix.trans,
//     P^T moved into the B-fragment layout by movmatrix.trans and entered
//     as hi + lo bf16 terms (16 bits of mantissa), so the output stays
//     within one bf16 ulp of the float32 plain version.  Each warp keeps
//     its own online softmax over its keys; the block merges its warps
//     through shared memory into the split's partial.  wgmma does not fit:
//     its 64-row minimum is far above decode's <= 8 query rows a kv head;
//   * float32 keeps scalar FMAs (TF32 would round the inputs): 8 warps
//     split the split's tokens in tiles of 32, one token a lane for the
//     scores against q in shared memory, Dh / 32 output dims a lane for
//     P.V, and the same partial and merge.
// Not yet done (later work): TMA page loads, and a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSplits = 256;          // split_plan stays within both
constexpr int kMaxSplitPages = 1024;

struct Args {
  const void* q; const void* k; const void* v; const int* pt;
  const int* lens; void* out;
  float* part_o;            // (B * Hk, n_split, G, Dh)
  float* part_ml;           // (B * Hk, n_split, G, 2): m, l
  int* tickets;             // (B * Hk,), zero between launches
  int B, H, Hk, n_pool, page_size, max_pages, window, pages_per_split,
      n_split;
  int page_shift;           // log2(page_size)
  float scale_log2;         // 1/sqrt(Dh) * log2(e): softmax in base 2
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// The tokens of split `split` of row b: [t_begin, t_end), the split's whole
// pages intersected with [lo, seq_len) and the table.
struct SplitRange {
  int t_begin, t_end;
};

__device__ __forceinline__ SplitRange split_range(const Args& a, int b,
                                                  int split) {
  const int seq_len = a.lens[b];
  const int hi = min(seq_len, a.max_pages * a.page_size);
  const int lo = a.window > 0 ? max(seq_len - a.window, 0) : 0;
  const int span = a.pages_per_split * a.page_size;
  return {max(lo, split * span), min(hi, (split + 1) * span)};
}

// The block's partial from its warps' (m, l, o) in shared memory (head g of
// warp w at w * HS + g, o at (w * HS + g) * DH), written to the workspace;
// then the ticket, and the merge in the split that draws the last one,
// with ml_s (2 * kMaxSplits * G floats of shared memory) as its scratch.
template <typename T, int DH, int G, int NW, int HS>
__device__ __forceinline__ void finish_split(const float* mw, const float* lw,
                                             const float* ow, float* ml_s,
                                             const Args& a, int pair,
                                             int split, int b, int kvh) {
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int64_t slot = (int64_t)pair * a.n_split + split;
  float* po = a.part_o + slot * G * DH;
  float* pml = a.part_ml + slot * G * 2;
  for (int idx = tid; idx < G * DH; idx += blockDim.x) {
    const int g = idx / DH;
    const int d = idx % DH;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) m = fmaxf(m, mw[w * HS + g]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = exp2f(mw[w * HS + g] - m);
      l += lw[w * HS + g] * f;
      o += ow[(w * HS + g) * DH + d] * f;
    }
    po[idx] = o;
    if (d == 0) {
      pml[2 * g] = m;
      pml[2 * g + 1] = l;
    }
  }
  // the ticket: the barrier orders every thread's partial before thread
  // 0's release fence, the fence before the atomic; the last split's
  // acquire fence orders the other splits' partials before its reads
  __syncthreads();
  if (tid == 0) {
    asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    s_last = atomicAdd(a.tickets + pair, 1) == a.n_split - 1;
    if (s_last) asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  }
  __syncthreads();
  if (!s_last) return;

  // the merge: every split's (m, l) into shared memory, one load each and
  // all at once; per head the weight of each split, exp2(m_s - m) / l, in
  // place of its m; then every output element as one pass of independent
  // loads over the splits
  const float* po0 = a.part_o + (int64_t)pair * a.n_split * G * DH;
  const float* pml0 = a.part_ml + (int64_t)pair * a.n_split * G * 2;
  for (int j = tid; j < 2 * a.n_split * G; j += blockDim.x)
    ml_s[j] = __ldcg(pml0 + j);
  __syncthreads();
  if (tid < G) {
    float m = kNegInf;
    for (int s = 0; s < a.n_split; ++s) m = fmaxf(m, ml_s[2 * (s * G + tid)]);
    float l = 0.f;
    for (int s = 0; s < a.n_split; ++s) {
      float& w = ml_s[2 * (s * G + tid)];
      w = exp2f(w - m);
      l += ml_s[2 * (s * G + tid) + 1] * w;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    for (int s = 0; s < a.n_split; ++s) ml_s[2 * (s * G + tid)] *= inv;
  }
  __syncthreads();
  constexpr int NT = 32 * NW;                     // the block's threads
  constexpr int PER = (G * DH + NT - 1) / NT;     // outputs a thread
  float o[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) o[k] = 0.f;
#pragma unroll 4
  for (int s = 0; s < a.n_split; ++s) {
    const float* ps = po0 + (int64_t)s * G * DH;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = tid + k * NT;
      if (idx < G * DH)
        o[k] += __ldcg(ps + idx) * ml_s[2 * (s * G + idx / DH)];
    }
  }
  T* ob = static_cast<T*>(a.out) + ((int64_t)b * a.H + (int64_t)kvh * G) * DH;
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (tid + k * NT < G * DH) store(ob + tid + k * NT, o[k]);
  if (tid == 0) a.tickets[pair] = 0;     // ready for the next launch
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 8;
constexpr int kF32Tile = 32;             // tokens a warp tile (one a lane)

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      f[i] = v.x; f[i + 1] = v.y; f[i + 2] = v.z; f[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      f[i] = v.x; f[i + 1] = v.y;
    }
  }
}

template <int DH, int G>
constexpr int f32_smem_bytes() {      // q, the warps' accumulators, merge
  return (G * DH + kF32Warps * G * DH + 2 * kMaxSplits * G) *
         static_cast<int>(sizeof(float));
}

template <int DH, int G>
__global__ void __launch_bounds__(kF32Warps * 32)
paged_split_f32_kernel(const Args a) {
  constexpr int DPL = DH / 32;            // output dims per lane in P.V
  // q (G x DH) and the warps' accumulators (kF32Warps x G x DH) live in
  // dynamic shared memory: at DH = 256 and G = 8 they take 72 KB
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* acc_s = q_s + G * DH;            // [kF32Warps][G][DH]
  __shared__ float m_s[kF32Warps][G];
  __shared__ float l_s[kF32Warps][G];

  const int pair = blockIdx.x;
  const int split = blockIdx.y;
  const int b = pair / a.Hk;
  const int kvh = pair % a.Hk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const float* qb = static_cast<const float*>(a.q) +
                    ((int64_t)b * a.H + (int64_t)kvh * G) * DH;
  for (int i = threadIdx.x; i < G * DH; i += blockDim.x) q_s[i] = qb[i];
  __syncthreads();

  const SplitRange sr = split_range(a, b, split);
  const int* pt = a.pt + (int64_t)b * a.max_pages;
  const int64_t tok_stride = (int64_t)a.Hk * DH;         // token to token
  const float* k_pages = static_cast<const float*>(a.k);
  const float* v_pages = static_cast<const float*>(a.v);

  float m_run[G], l_run[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  for (int t0 = sr.t_begin + warp * kF32Tile; t0 < sr.t_end;
       t0 += kF32Warps * kF32Tile) {
    // ---- scores: lane scores token t0 + lane against the G query rows
    const int t = t0 + lane;
    long long row = 0;                     // element offset of (t, kvh, 0)
    float s[G];
    if (t < sr.t_end) {
      int pid = pt[t / a.page_size];
      pid = min(max(pid, 0), a.n_pool - 1);
      row = ((long long)pid * a.page_size + t % a.page_size) * tok_stride +
            (long long)kvh * DH;
      const float* kr = k_pages + row;
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll 4
      for (int c = 0; c < DH; c += 4) {
        float kf[4];
        load_vec<4>(kr + c, kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            s[g] = fmaf(q_s[g * DH + c + i], kf[i], s[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] *= a.scale_log2;
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = kNegInf;
    }

    // ---- one online-softmax rescale per tile (lane 0's token is always
    // real, so the tile max is a real score and masked lanes give p = 0)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_new = fmaxf(m_run[g], warp_max(s[g]));
      const float alpha = exp2f(m_run[g] - m_new);
      s[g] = exp2f(s[g] - m_new);          // s now holds p
      l_run[g] = l_run[g] * alpha + warp_sum(s[g]);
      m_run[g] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
    }

    // ---- P.V: lane owns dims [lane*DPL, (lane+1)*DPL) of every group row
    const int n_in = min(kF32Tile, sr.t_end - t0);
#pragma unroll 4
    for (int j = 0; j < n_in; ++j) {
      const long long rj = __shfl_sync(kFull, row, j);
      float vf[DPL];
      load_vec<DPL>(v_pages + rj + lane * DPL, vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pj = __shfl_sync(kFull, s[g], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] = fmaf(pj, vf[i], acc[g][i]);
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m_s[warp][g] = m_run[g];
      l_s[warp][g] = l_run[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      acc_s[(warp * G + g) * DH + lane * DPL + i] = acc[g][i];
  __syncthreads();
  finish_split<float, DH, G, kF32Warps, G>(
      &m_s[0][0], &l_s[0][0], acc_s, acc_s + kF32Warps * G * DH, a, pair,
      split, b, kvh);
}

// ---------------------------------------------------------------------------
// bf16: cp.async ring, mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kStages = 3;

template <int DH>
struct MmaLayout {
  static constexpr int kWarps = DH == 256 ? 2 : 4;
  static constexpr int kTile = 16 * kWarps;       // tokens a tile
  static constexpr int kPitch = DH + 8;           // bf16 a row: ldmatrix's 8
                                                  // row addresses in distinct
                                                  // banks
  static constexpr int kTileElems = kTile * kPitch;
  static constexpr int kRingBytes = 2 * kStages * kTileElems * 2;
  // the warps' (m, l, o), then the merge's scratch
  static constexpr int kMergeBytes =
      (2 * kWarps * 8 + kWarps * 8 * DH + 2 * kMaxSplits * 8) * 4;
  static_assert(kMergeBytes <= kRingBytes, "the merge reuses the ring");
  // + the split's page ids (int32), at most kMaxSplitPages
  static constexpr int kMaxSmemBytes = kRingBytes + 4 * kMaxSplitPages;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until cp_async_wait; ok == false
// reads nothing and fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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

// the transpose of the 8 x 8 bf16 matrix whose fragment this lane holds
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
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
// half (the lower column of a fragment)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int DH, int G>
__global__ void __launch_bounds__(32 * MmaLayout<DH>::kWarps)
paged_split_mma_kernel(const Args a) {
  using L = MmaLayout<DH>;
  constexpr int W = L::kWarps;
  constexpr int KT = L::kTile;
  constexpr int P = L::kPitch;
  constexpr int CH = DH / 8;              // 16-byte chunks a token row
  constexpr int KS = DH / 16;             // 16-wide steps along Dh
  constexpr int kThreads = 32 * W;

  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);        // [kStages][KT][P]
  bf16* vs = ks + kStages * L::kTileElems;

  const int pair = blockIdx.x;
  const int split = blockIdx.y;
  const int b = pair / a.Hk;
  const int kvh = pair % a.Hk;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane / 4;               // fragment row within 8
  const int tig = lane % 4;               // fragment column pair
  const int lm_row = lane % 8;            // ldmatrix: lane l feeds row l % 8
  const int lm_mat = lane / 8;            // of matrix l / 8

  const SplitRange sr = split_range(a, b, split);
  const int n_tiles = sr.t_end > sr.t_begin
                          ? (sr.t_end - sr.t_begin + KT - 1) / KT : 0;
  const int64_t tok_stride = (int64_t)a.Hk * DH;
  const bf16* k_pages = static_cast<const bf16*>(a.k);
  const bf16* v_pages = static_cast<const bf16*>(a.v);

  // the split's page ids, clamped to the pool, into shared memory once, so
  // that no copy waits on a table read
  int* pid_s = reinterpret_cast<int*>(
      reinterpret_cast<char*>(smem4) + L::kRingBytes);
  const int first_page = sr.t_begin >> a.page_shift;
  const int n_pages =
      n_tiles > 0 ? ((sr.t_end - 1) >> a.page_shift) - first_page + 1 : 0;
  const int* pt = a.pt + (int64_t)b * a.max_pages + first_page;
  for (int j = tid; j < n_pages; j += kThreads)
    pid_s[j] = min(max(pt[j], 0), a.n_pool - 1);
  __syncthreads();

  // a thread copies 16-byte chunk tid % CH of rows tid / CH + n * RSTEP
  constexpr int RSTEP = kThreads / CH;
  static_assert(kThreads % CH == 0 && KT % RSTEP == 0, "copy layout");
  const int ch = tid % CH;
  const int r0 = tid / CH;
  const int page_mask = (1 << a.page_shift) - 1;
  auto load_tile = [&](int i) {
    const int st = i % kStages;
    const int tb = sr.t_begin + i * KT;
#pragma unroll
    for (int n = 0; n < KT / RSTEP; ++n) {
      const int r = r0 + n * RSTEP;
      const int t = tb + r;
      const bool ok = t < sr.t_end;
      int64_t off = 0;
      if (ok) {
        const int pid = pid_s[(t >> a.page_shift) - first_page];
        off = (((int64_t)pid << a.page_shift) + (t & page_mask)) *
                  tok_stride + (int64_t)kvh * DH + ch * 8;
      }
      const int at = (st * KT + r) * P + ch * 8;
      cp_async16(ks + at, k_pages + off, ok);
      cp_async16(vs + at, v_pages + off, ok);
    }
  };

  // start the ring, then fetch q as B fragments (head grp; zero past G)
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }
  uint32_t qf[KS][2];
  const bf16* qh = static_cast<const bf16*>(a.q) +
                   ((int64_t)b * a.H + (int64_t)kvh * G + grp) * DH;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qf[kk][0] = grp < G ? *reinterpret_cast<const uint32_t*>(
                              qh + 16 * kk + 2 * tig) : 0u;
    qf[kk][1] = grp < G ? *reinterpret_cast<const uint32_t*>(
                              qh + 16 * kk + 8 + 2 * tig) : 0u;
  }

  // this lane: heads 2 tig + e of every fragment (columns), keys grp and
  // grp + 8 of the warp's 16 (score rows), dims 16 mt + grp (+ 8) of O^T
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};            // this lane's share of l
  float o[KS][4];
#pragma unroll
  for (int mt = 0; mt < KS; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[mt][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();          // tile i has landed
    __syncthreads();                       // ... for every thread, and
                                           // tile i - 1's stage is free
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    cp_async_commit();

    const int key0 = sr.t_begin + i * KT + 16 * warp;
    if (key0 >= sr.t_end) continue;        // this warp's keys are past the end
    const int st = i % kStages;
    const bf16* kt = ks + (st * KT + 16 * warp) * P;
    const bf16* vt = vs + (st * KT + 16 * warp) * P;

    // ---- S^T = K q^T: 16 keys x 8 heads
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t af[4];
      // matrices: keys 0-7 / 8-15 x dims 0-7 / 8-15 of the step
      ldmatrix_x4(af, kt + (lm_row + (lm_mat % 2) * 8) * P + 16 * kk +
                          (lm_mat / 2) * 8);
      mma_bf16(sc, af, qf[kk][0], qf[kk][1]);
    }
    const bool vis0 = key0 + grp < sr.t_end;
    const bool vis1 = key0 + grp + 8 < sr.t_end;
    sc[0] = vis0 ? sc[0] * a.scale_log2 : kNegInf;
    sc[1] = vis0 ? sc[1] * a.scale_log2 : kNegInf;
    sc[2] = vis1 ? sc[2] * a.scale_log2 : kNegInf;
    sc[3] = vis1 ? sc[3] * a.scale_log2 : kNegInf;

    // ---- online softmax per head over the warp's keys (key0 is real, so
    // the max is a real score and masked keys give p = 0)
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float tmax = fmaxf(sc[e], sc[2 + e]);
      tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 4));
      tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 8));
      tmax = fmaxf(tmax, __shfl_xor_sync(kFull, tmax, 16));
      const float m_new = fmaxf(m_run[e], tmax);
      alpha[e] = exp2f(m_run[e] - m_new);
      sc[e] = exp2f(sc[e] - m_new);
      sc[2 + e] = exp2f(sc[2 + e] - m_new);
      l_run[e] = l_run[e] * alpha[e] + sc[e] + sc[2 + e];
      m_run[e] = m_new;
    }
#pragma unroll
    for (int mt = 0; mt < KS; ++mt) {
      o[mt][0] *= alpha[0];
      o[mt][1] *= alpha[1];
      o[mt][2] *= alpha[0];
      o[mt][3] *= alpha[1];
    }

    // ---- P^T as B fragments (keys 2 tig.. x head grp), hi + lo
    uint32_t h01, l01, h23, l23;
    split_bf16(sc[0], sc[1], h01, l01);
    split_bf16(sc[2], sc[3], h23, l23);
    const uint32_t bh0 = movmatrix_trans(h01);
    const uint32_t bh1 = movmatrix_trans(h23);
    const uint32_t bl0 = movmatrix_trans(l01);
    const uint32_t bl1 = movmatrix_trans(l23);

    // ---- O^T += V^T P^T: dims 16 mt .. + 15 x 8 heads
#pragma unroll
    for (int mt = 0; mt < KS; ++mt) {
      uint32_t av[4];
      // matrices: keys 0-7 / 8-15 x dims 0-7 / 8-15, transposed
      ldmatrix_x4_trans(av, vt + ((lm_mat / 2) * 8 + lm_row) * P + 16 * mt +
                                (lm_mat % 2) * 8);
      mma_bf16(o[mt], av, bh0, bh1);
      mma_bf16(o[mt], av, bl0, bl1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                         // the ring becomes the merge area

  float* mw = reinterpret_cast<float*>(smem4);     // [W][8]
  float* lw = mw + W * 8;                          // [W][8]
  float* ow = lw + W * 8;                          // [W][8][DH]
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float l = l_run[e];
    l += __shfl_xor_sync(kFull, l, 4);
    l += __shfl_xor_sync(kFull, l, 8);
    l += __shfl_xor_sync(kFull, l, 16);
    if (grp == 0) {
      mw[warp * 8 + 2 * tig + e] = m_run[e];
      lw[warp * 8 + 2 * tig + e] = l;
    }
  }
#pragma unroll
  for (int mt = 0; mt < KS; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ow[(warp * 8 + 2 * tig + (e & 1)) * DH + 16 * mt + grp + 8 * (e >> 1)] =
          o[mt][e];
  __syncthreads();
  finish_split<bf16, DH, G, W, 8>(mw, lw, ow, ow + W * 8 * DH, a, pair,
                                  split, b, kvh);
}

template <typename T, int DH, int G>
int launch(const Args& a, cudaStream_t stream) {
  constexpr bool kMma = sizeof(T) == 2;
  // the mma kernel's ring, then the split's page ids
  constexpr int max_bytes = kMma ? MmaLayout<DH>::kMaxSmemBytes
                                 : f32_smem_bytes<DH, G>();
  const int bytes = kMma ? MmaLayout<DH>::kRingBytes + 4 * a.pages_per_split
                         : max_bytes;
  constexpr int threads = kMma ? 32 * MmaLayout<DH>::kWarps : 32 * kF32Warps;
  const void* fn = kMma
      ? reinterpret_cast<const void*>(paged_split_mma_kernel<DH, G>)
      : reinterpret_cast<const void*>(paged_split_f32_kernel<DH, G>);
  if (max_bytes > 48 * 1024) {
    // above 48 KB a kernel must opt in to dynamic shared memory; the
    // attribute is per kernel instance and cheap to set again
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(a.B * a.Hk, a.n_split);
  if constexpr (kMma)
    paged_split_mma_kernel<DH, G><<<grid, threads, bytes, stream>>>(a);
  else
    paged_split_f32_kernel<DH, G><<<grid, threads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_g(int G, const Args& a, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, DH, 1>(a, stream);
    case 2: return launch<T, DH, 2>(a, stream);
    case 4: return launch<T, DH, 4>(a, stream);
    case 8: return launch<T, DH, 8>(a, stream);
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

// dtype: 0 = float32, 1 = bfloat16.  part_o (B*Hk, n_split, G, Dh) and
// part_ml (B*Hk, n_split, G, 2) are float32 scratch the caller owns;
// tickets (B*Hk,) int32 must be zero before the first launch, and every
// launch leaves them zero.  Returns cudaGetLastError() after the launch
// (0 = launched), or -1 for a shape or dtype this file has no instance
// of.  Launches on `stream` and does not synchronise.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* seq_lens, void* out, void* part_o,
    void* part_ml, void* tickets, int B, int H, int Hk, int Dh, int n_pool,
    int page_size, int max_pages, int window, int pages_per_split,
    int n_split, float scale, int dtype, void* stream) {
  if (B <= 0 || Hk <= 0 || H % Hk != 0 || pages_per_split <= 0 ||
      pages_per_split > kMaxSplitPages || n_split <= 0 ||
      n_split > kMaxSplits || n_split * pages_per_split < max_pages ||
      page_size <= 0 || (page_size & (page_size - 1)) != 0)
    return -1;
  const Args a{q, k_pages, v_pages, static_cast<const int*>(page_table),
               static_cast<const int*>(seq_lens), out,
               static_cast<float*>(part_o), static_cast<float*>(part_ml),
               static_cast<int*>(tickets), B, H, Hk, n_pool, page_size,
               max_pages, window, pages_per_split, n_split,
               __builtin_ctz(static_cast<unsigned>(page_size)),
               scale * kLog2e};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / Hk;
  switch (dtype) {
    case 0: return launch_dh<float>(Dh, G, a, s);
    case 1: return launch_dh<bf16>(Dh, G, a, s);
    default: return -1;
  }
}
