// Paged decode attention for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (`paged_decode_attention`, kernel body `_paged_kernel`): one-token GQA
// decode attention over a shared page pool.  It computes what that kernel
// computes, not how: the TPU grid's sequential walk over blocks of pages
// becomes a loop inside a CUDA block.
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
// flops per byte at which the tensor cores would be the limit.  So the
// design spends nothing on tensor cores and everything on reading each
// byte once:
//   * one block per (b, kv-head): the G query heads of a group share every
//     K/V row load (GQA reuse), and q sits in shared memory;
//   * the block's 8 warps split the row's tokens in tiles of 32; in a tile
//     each lane scores one token (16-byte loads of its K row against q in
//     shared memory, no shuffle per dot), the warp runs one online-softmax
//     rescale per tile, and for P.V each lane owns Dh/32 output dims and
//     reads the tile's V rows coalesced;
//   * the warps' (m, l, acc) are merged through shared memory at the end.
// Not yet done (later work): split-KV across blocks so that few rows with
// long sequences fill all 132 SMs, and TMA / wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 8;
constexpr int kTile = 32;                // tokens per warp tile (one per lane)
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// N consecutive elements (N even, p aligned to the vector width) -> floats.
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

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = __bfloat1622float2(h[j]);
        f[i + 2 * j] = x.x; f[i + 2 * j + 1] = x.y;
      }
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint2 raw = *reinterpret_cast<const uint2*>(p + i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 x = __bfloat1622float2(h[j]);
        f[i + 2 * j] = x.x; f[i + 2 * j + 1] = x.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 x =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
      f[i] = x.x; f[i + 1] = x.y;
    }
  }
}

template <typename T, int DH, int G>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    int H, int Hk, int n_pool, int page_size, int max_pages,
                    int window, float scale) {
  constexpr int DPL = DH / 32;            // output dims per lane in P.V
  constexpr int CH = 16 / sizeof(T);      // elements per 16-byte K load
  // q (G x DH) and the warps' accumulators (kWarps x G x DH) live in
  // dynamic shared memory, sized by smem_bytes<G, DH>(): at DH = 256 and
  // G = 8 they take 72 KB, past the 48 KB that static arrays may use
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* acc_s = q_s + G * DH;            // [kWarps][G][DH]
  __shared__ float m_s[kWarps][G];
  __shared__ float l_s[kWarps][G];

  const int b = blockIdx.x / Hk;
  const int kvh = blockIdx.x % Hk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int64_t head0 = (int64_t)b * H + (int64_t)kvh * G;
  const T* qb = q + head0 * DH;
  for (int i = threadIdx.x; i < G * DH; i += blockDim.x) q_s[i] = to_float(qb[i]);
  __syncthreads();

  const int seq_len = seq_lens[b];
  const int hi = min(seq_len, max_pages * page_size);   // tokens in the table
  const int lo = window > 0 ? max(seq_len - window, 0) : 0;
  const int* pt = page_table + (int64_t)b * max_pages;
  const int64_t tok_stride = (int64_t)Hk * DH;           // token to token

  float m_run[G], l_run[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  for (int t0 = lo + warp * kTile; t0 < hi; t0 += kWarps * kTile) {
    // ---- scores: lane scores token t0 + lane against the G query rows
    const int t = t0 + lane;
    long long row = 0;                     // element offset of (t, kvh, 0)
    float s[G];
    if (t < hi) {
      int pid = pt[t / page_size];
      pid = min(max(pid, 0), n_pool - 1);
      row = ((long long)pid * page_size + t % page_size) * tok_stride +
            (long long)kvh * DH;
      const T* kr = k_pages + row;
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll 4
      for (int c = 0; c < DH; c += CH) {
        float kf[CH];
        load_vec<CH>(kr + c, kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int i = 0; i < CH; ++i)
            s[g] = fmaf(q_s[g * DH + c + i], kf[i], s[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] *= scale;
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = kNegInf;
    }

    // ---- one online-softmax rescale per tile (lane 0's token is always
    // real, so the tile max is a real score and masked lanes give p = 0)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_new = fmaxf(m_run[g], warp_max(s[g]));
      const float alpha = expf(m_run[g] - m_new);
      s[g] = expf(s[g] - m_new);           // s now holds p
      l_run[g] = l_run[g] * alpha + warp_sum(s[g]);
      m_run[g] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
    }

    // ---- P.V: lane owns dims [lane*DPL, (lane+1)*DPL) of every group row
    const int n_in = min(kTile, hi - t0);
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

  // ---- merge the warps' (m, l, acc)
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

  T* ob = out + head0 * DH;
  for (int idx = threadIdx.x; idx < G * DH; idx += blockDim.x) {
    const int g = idx / DH;
    const int d = idx % DH;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, m_s[w][g]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_s[w][g] - m);
      l += l_s[w][g] * f;
      o += acc_s[(w * G + g) * DH + d] * f;
    }
    store(ob + idx, o / fmaxf(l, 1e-30f));
  }
}

struct Args {
  const void* q; const void* k; const void* v; const int* pt;
  const int* lens; void* out;
  int B, H, Hk, n_pool, page_size, max_pages, window;
  float scale;
};

template <int G, int DH>
constexpr int smem_bytes() {
  return (G * DH + kWarps * G * DH) * static_cast<int>(sizeof(float));
}

template <typename T, int DH, int G>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<G, DH>();
  if (bytes > 48 * 1024) {
    // above 48 KB a kernel must opt in to dynamic shared memory; the
    // attribute is per kernel instance and cheap to set again
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, DH, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  paged_decode_kernel<T, DH, G><<<a.B * a.Hk, kWarps * 32, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.pt, a.lens, static_cast<T*>(a.out),
      a.H, a.Hk, a.n_pool, a.page_size, a.max_pages, a.window, a.scale);
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

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 = launched), or -1 for a shape or dtype this file has no
// instance of.  Launches on `stream` and does not synchronise.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* seq_lens, void* out, int B, int H,
    int Hk, int Dh, int n_pool, int page_size, int max_pages, int window,
    float scale, int dtype, void* stream) {
  if (B <= 0 || Hk <= 0 || H % Hk != 0) return -1;
  const Args a{q, k_pages, v_pages, static_cast<const int*>(page_table),
               static_cast<const int*>(seq_lens), out, B, H, Hk, n_pool,
               page_size, max_pages, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / Hk;
  switch (dtype) {
    case 0: return launch_dh<float>(Dh, G, a, s);
    case 1: return launch_dh<__nv_bfloat16>(Dh, G, a, s);
    default: return -1;
  }
}
