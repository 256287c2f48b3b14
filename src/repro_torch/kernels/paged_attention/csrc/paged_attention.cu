// paged_attention for Hopper (sm_90a): GQA decode attention over a paged
// KV pool, one query token per sequence, fp32 online softmax.
//
// Replaces the TPU kernel paged_attention in
// src/repro/kernels/paged_attention/kernel.py:76 (pl.pallas_call at :117).
// That kernel walks a (batch, kv head, page) grid with the page axis
// sequential, takes the block table and the lengths by scalar prefetch so
// that the page id feeds the BlockSpec's DMA, and keeps the fp32 running
// max, sum and accumulator of the head's query group in VMEM scratch. Here
// one CTA owns one (batch row, KV head): it reads its row's length and
// table itself (there is no scalar prefetch), and a loop inside it takes
// the place of the sequential page axis, so nothing is carried between
// CTAs.
//
// Semantics, as the reference: q [B, Hq, D]; k_pages, v_pages
// [n_pool, page, Hkv, D] (one layer of the pool); block_tables [B, pps]
// int32; seq_lens [B] int32. Position s of row b lives at offset s % page
// of pool page block_tables[b][s / page]. Query heads h*g .. h*g+g-1
// (g = Hq / Hkv) read KV head h. Scores are (q . k) * scale in fp32;
// positions at or past min(seq_len, pps * page) are never read; the output
// is acc / max(l, 1e-30) in q's dtype. A row of length 0 reads nothing and
// writes 0, as the Pallas kernel does. A table entry outside [0, n_pool) is
// clamped into it, as JAX's gather clamps, so no read leaves the pool (the
// wrapper cannot check the entries without a host sync). f32 and bf16; D a
// multiple of 4 up to 128; g up to 16.
//
// Design. Eight warps split the row's positions into 32-position tiles,
// tile t going to warp t % 8, each warp with its own running (m, l, acc)
// for the g heads, so no barrier is needed inside the loop. In a tile,
// lane j finds position t0 + j's pool offset (its page from the table);
// the warp then reads the tile's K rows one at a time, every lane four
// consecutive values of the row (one coalesced row read a step), and forms
// each head's score by a warp sum; lane j keeps the scores of position j.
// After the tile's max and exp (warp reductions, as flash_attention), the
// V rows are read the same way and each lane accumulates its four output
// columns, taking position j's probabilities from lane j by shuffle. Only
// rows below the length are read, so the 0-padded tail of a table is
// never touched. At the end the eight warps' states are merged through
// shared memory (the log-sum-exp combination of split-KV decoding).
//
// What bounds it on this card. The function reads each visible K and V
// row once, seq_len * Hkv * D * 2 values a batch row, plus q, the tables
// and the output, and does 4 * Hq * D FLOPs a position: at qwen3-0.6b's
// decode (B 32, lengths near 2080, Hkv 8, D 128, bf16) that is 273 MB
// against 1.1 GFLOP, 0.08 ms at 3.35 TB/s, so the bytes bound it. This
// kernel issues its loads row by row, one tile in flight per warp (the
// wait of each tile's two rounds of reads is exposed) and 256 CTAs at
// that shape: its cost is latency, not bandwidth. What it leaves: a
// multi-stage cp.async or TMA ring of pages, 16-byte loads of bf16 octets,
// and a split of long rows across CTAs (split-KV) to fill the SMs at small
// batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 32;                     // positions a warp takes
constexpr int kMaxD = 128;
constexpr int kMaxGroup = 16;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(x.x, x.y);
  p2[1] = __floats2bfloat162_rn(x.z, x.w);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// G: a power of two at least the group size g (the register arrays'
// extent); heads r >= g are skipped.
template <typename T, int G>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ tables,
                       const int* __restrict__ lens, T* __restrict__ out,
                       int n_pool, int Hq, int Hkv, int D, int page,
                       int pps, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = Hq / Hkv;
  const int c = lane * 4;                    // this lane's four columns
  const bool own = c < D;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  const T* qg = q + (static_cast<long long>(b) * Hq + h * g) * D + c;
  float4 qr[G];
#pragma unroll
  for (int r = 0; r < G; ++r) qr[r] = (r < g && own) ? load4(qg + r * D) : zero;

  int len = lens[b];
  len = max(0, min(len, pps * page));
  const int* tab = tables + static_cast<long long>(b) * pps;

  float m[G], l[G], acc[G][4];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }

  for (int t0 = warp * kTile; t0 < len; t0 += kWarps * kTile) {
    const int n = min(kTile, len - t0);
    long long off = 0;                       // position t0 + lane's row
    if (lane < n) {
      const int s = t0 + lane;
      const long long pid = min(max(tab[s / page], 0), n_pool - 1);
      off = ((pid * page + s % page) * Hkv + h) * static_cast<long long>(D);
    }

    float sc[G];
#pragma unroll
    for (int r = 0; r < G; ++r) sc[r] = kNegInf;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const long long oj = __shfl_sync(kFull, off, j);
      const float4 kk = own ? load4(kp + oj + c) : zero;
#pragma unroll
      for (int r = 0; r < G; ++r) {
        if (r < g) {
          const float part = warp_sum(qr[r].x * kk.x + qr[r].y * kk.y +
                                      qr[r].z * kk.z + qr[r].w * kk.w);
          if (lane == j) sc[r] = part * scale;
        }
      }
    }

#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r < g) {
        const float m_new = fmaxf(m[r], warp_max(sc[r]));
        const float p = expf(sc[r] - m_new);
        const float alpha = expf(m[r] - m_new);
        l[r] = l[r] * alpha + p;             // per-lane partial sum
        m[r] = m_new;
        acc[r][0] *= alpha;
        acc[r][1] *= alpha;
        acc[r][2] *= alpha;
        acc[r][3] *= alpha;
        sc[r] = p;
      }
    }

#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const long long oj = __shfl_sync(kFull, off, j);
      const float4 vv = own ? load4(vp + oj + c) : zero;
#pragma unroll
      for (int r = 0; r < G; ++r) {
        if (r < g) {
          const float pj = __shfl_sync(kFull, sc[r], j);
          acc[r][0] += pj * vv.x;
          acc[r][1] += pj * vv.y;
          acc[r][2] += pj * vv.z;
          acc[r][3] += pj * vv.w;
        }
      }
    }
  }

  // merge the warps' states: ms, ls [kWarps][g], as [kWarps][g][D]
  float* ms = smem;
  float* ls = ms + kWarps * g;
  float* as = ls + kWarps * g;
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (r < g) {
      const float lsum = warp_sum(l[r]);
      if (lane == 0) {
        ms[warp * g + r] = m[r];
        ls[warp * g + r] = lsum;
      }
      if (own)
        store4(as + (warp * g + r) * D + c,
               make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
    }
  }
  __syncthreads();
  for (int r = warp; r < g; r += kWarps) {
    float top = kNegInf;
    for (int w = 0; w < kWarps; ++w) top = fmaxf(top, ms[w * g + r]);
    float lsum = 0.f;
    float4 o = zero;
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(ms[w * g + r] - top);
      lsum += ls[w * g + r] * a;
      if (own) {
        const float4 x = load4(as + (w * g + r) * D + c);
        o.x += a * x.x;
        o.y += a * x.y;
        o.z += a * x.z;
        o.w += a * x.w;
      }
    }
    const float denom = fmaxf(lsum, 1e-30f);
    if (own)
      store4(out + (static_cast<long long>(b) * Hq + h * g + r) * D + c,
             make_float4(o.x / denom, o.y / denom, o.z / denom,
                         o.w / denom));
  }
}

template <typename T, int G>
int launch_group(const void* q, const void* kp, const void* vp,
                 const int* tables, const int* lens, void* out, int B,
                 int n_pool, int Hq, int Hkv, int D, int page, int pps,
                 float scale, cudaStream_t stream) {
  const int g = Hq / Hkv;
  const int smem = kWarps * g * (D + 2) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(Hkv, B);
  paged_attention_kernel<T, G><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, lens, static_cast<T*>(out), n_pool,
      Hq, Hkv, D, page, pps, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* lens, void* out, int B, int n_pool, int Hq, int Hkv,
           int D, int page, int pps, float scale, cudaStream_t stream) {
  const int g = Hq / Hkv;
  if (g <= 1)
    return launch_group<T, 1>(q, kp, vp, tables, lens, out, B, n_pool, Hq,
                              Hkv, D, page, pps, scale, stream);
  if (g <= 2)
    return launch_group<T, 2>(q, kp, vp, tables, lens, out, B, n_pool, Hq,
                              Hkv, D, page, pps, scale, stream);
  if (g <= 4)
    return launch_group<T, 4>(q, kp, vp, tables, lens, out, B, n_pool, Hq,
                              Hkv, D, page, pps, scale, stream);
  if (g <= 8)
    return launch_group<T, 8>(q, kp, vp, tables, lens, out, B, n_pool, Hq,
                              Hkv, D, page, pps, scale, stream);
  return launch_group<T, kMaxGroup>(q, kp, vp, tables, lens, out, B, n_pool,
                                    Hq, Hkv, D, page, pps, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success);
// the caller also checks shapes, contiguity and 16-byte alignment. The
// kernel reads a row's first ceil(min(seq_len, pps * page) / page) table
// entries and those pages, no other.
extern "C" int paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const void* tables,
                               const void* lens, void* out, int B,
                               int n_pool, int Hq, int Hkv, int D, int page,
                               int pps, float scale, int dtype,
                               void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (D <= 0 || D % 4 != 0 || D > kMaxD || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > kMaxGroup || page <= 0 || pps < 0 || n_pool <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* n = static_cast<const int*>(lens);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, t, n, out, B, n_pool, Hq, Hkv,
                         D, page, pps, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, t, n, out, B, n_pool,
                                 Hq, Hkv, D, page, pps, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
