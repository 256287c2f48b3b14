// flash_attention for Hopper (sm_90a): causal / sliding-window prefill
// attention with an fp32 online softmax.
//
// Replaces the TPU kernel flash_attention in
// src/repro/kernels/flash_attention/kernel.py:98 (pl.pallas_call at :128),
// which walks a (batch, head, q-block, kv-block) grid with the kv-block axis
// sequential and keeps the fp32 running max, sum and accumulator in VMEM
// scratch across it. Here one CTA owns one (b, h, 32-row q tile) and a loop
// inside it takes the place of that sequential axis: it visits only the
// 32-key tiles the causal / window band can reach (the TPU kernel's pl.when
// skip), so nothing is carried between CTAs.
//
// Semantics, as the reference: q [B, Hq, Sq, D]; k [B, Hkv, Skv, D] and
// v [B, Hkv, Skv, Dv], query head h reading KV head h / (Hq / Hkv) (the
// reference's repeated heads, without the copy); positions absolute from 0
// on both axes (k_pos <= q_pos even when Sq != Skv); a key is seen when
// k_pos < Skv, k_pos <= q_pos (causal) and k_pos > q_pos - window
// (window > 0). Scores are (q . k) * scale in fp32; masked scores are the
// finite -1e30, never -inf: a row whose first visited tile is fully masked
// accumulates garbage at m = -1e30 that the first real score wipes
// (alpha = 0), where -inf would give NaN. The output [B, Hq, Sq, Dv] is
// acc / max(l, 1e-30) in q's dtype. f32 and bf16 inputs; D and Dv multiples
// of 4 up to 128, so zamba2's 112 needs no padding.
//
// Design. Four warps own eight query rows each. A KV tile is staged in
// shared memory as fp32 (K rows padded by four floats, so the 16-byte reads
// of a lane's own key row never share a bank with its neighbours'). For the
// scores each lane takes one key and walks D in float4 steps, reading its
// key row and broadcasting the warp's eight query rows, so a K read feeds
// eight rows. The tile's max is a warp reduction; the running sum stays a
// per-lane partial (alpha is uniform over the row) and is reduced once at
// the end. For P.V each lane owns four output columns and takes the eight
// rows' probabilities of key j from lane j by shuffle.
//
// What bounds it on this card. The function needs 2 * (D + Dv) FLOPs for
// every (query, seen key) pair, about half the square when causal, and moves
// q, k, v and the output once. At zamba2-7b's prefill ([4, 32, 2048, 112]
// bf16, causal) that is 120 GFLOP against 235 MB: 0.12 ms on the bf16
// tensor cores (989 TFLOP/s) against 0.07 ms at 3.35 TB/s, so the
// operations bound it. This kernel does its FLOPs as fp32 FMAs out of shared
// memory and uses no tensor cores, so it sits about two orders of magnitude
// above that bound. What it leaves: wgmma on bf16 tiles staged by TMA in a
// multi-stage ring with warp specialisation (FlashAttention-3), larger q
// tiles, and 16-byte global loads of bf16 octets.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 8;                      // query rows per warp
constexpr int kBlockQ = kWarps * kRows;       // 32 rows a CTA
constexpr int kBlockKV = 32;                  // one key per lane
constexpr int kMaxD = 128;
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

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Hq,
                       int Hkv, int Sq, int Skv, int D, int Dv, float scale,
                       int causal, int window) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldk = D + 4;
  float* qs = smem;                          // [kBlockQ][D]
  float* ks = qs + kBlockQ * D;              // [kBlockKV][D + 4]
  float* vs = ks + kBlockKV * ldk;           // [kBlockKV][Dv]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const long long bq = static_cast<long long>(blockIdx.z) * Hq + h;
  const long long bkv = static_cast<long long>(blockIdx.z) * Hkv +
                        h / (Hq / Hkv);
  const T* qg = q + bq * Sq * D;
  const T* kg = k + bkv * Skv * D;
  const T* vg = v + bkv * Skv * Dv;
  const int d4 = D / 4;
  const int dv4 = Dv / 4;

  for (int i = tid; i < kBlockQ * d4; i += kWarps * 32) {
    const int r = i / d4;
    const int c = (i - r * d4) * 4;
    const int qr = q0 + r;
    store4(qs + r * D + c,
           qr < Sq ? load4(qg + static_cast<long long>(qr) * D + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f));
  }

  // the KV tiles the band can reach
  int kt_end = (Skv + kBlockKV - 1) / kBlockKV;
  if (causal) kt_end = min(kt_end, (q0 + kBlockQ - 1) / kBlockKV + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;          // first key any row can see
    kt_begin = lo > 0 ? lo / kBlockKV : 0;
  }

  float m[kRows], l[kRows], acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  }
  const bool own = lane * 4 < Dv;            // this lane's output columns
  const float* qw = qs + warp * kRows * D;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockKV;
    __syncthreads();                         // previous tile consumed
    for (int i = tid; i < kBlockKV * d4; i += kWarps * 32) {
      const int r = i / d4;
      const int c = (i - r * d4) * 4;
      const int kr = k0 + r;
      store4(ks + r * ldk + c,
             kr < Skv ? load4(kg + static_cast<long long>(kr) * D + c)
                      : make_float4(0.f, 0.f, 0.f, 0.f));
    }
    for (int i = tid; i < kBlockKV * dv4; i += kWarps * 32) {
      const int r = i / dv4;
      const int c = (i - r * dv4) * 4;
      const int kr = k0 + r;
      store4(vs + r * Dv + c,
             kr < Skv ? load4(vg + static_cast<long long>(kr) * Dv + c)
                      : make_float4(0.f, 0.f, 0.f, 0.f));
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = ks + lane * ldk;
    for (int c = 0; c < D; c += 4) {
      const float4 kk = load4(krow + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq = load4(qw + r * D + c);
        s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + warp * kRows + r;
      bool seen = kpos < Skv;
      if (causal) seen = seen && kpos <= qpos;
      if (window > 0) seen = seen && kpos > qpos - window;
      const float sc = seen ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float p = expf(sc - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + p;
      m[r] = m_new;
      acc[r][0] *= alpha;
      acc[r][1] *= alpha;
      acc[r][2] *= alpha;
      acc[r][3] *= alpha;
      s[r] = p;
    }

    for (int j = 0; j < kBlockKV; ++j) {
      const float4 vv = own ? load4(vs + j * Dv + lane * 4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(kFull, s[r], j);
        acc[r][0] += pj * vv.x;
        acc[r][1] += pj * vv.y;
        acc[r][2] += pj * vv.z;
        acc[r][3] += pj * vv.w;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float denom = fmaxf(warp_sum(l[r]), 1e-30f);
    const int qr = q0 + warp * kRows + r;
    if (qr < Sq && own) {
      store4(out + (bq * Sq + qr) * Dv + lane * 4,
             make_float4(acc[r][0] / denom, acc[r][1] / denom,
                         acc[r][2] / denom, acc[r][3] / denom));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Skv, int D, int Dv, float scale,
           int causal, int window, cudaStream_t stream) {
  const int smem = (kBlockQ * D + kBlockKV * (D + 4) + kBlockKV * Dv) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_attention_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Sq, Skv, D,
      Dv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success);
// the caller also checks contiguity and 16-byte alignment.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int Hq, int Hkv, int Sq,
                               int Skv, int D, int Dv, float scale,
                               int causal, int window, int dtype,
                               void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (D <= 0 || D % 4 != 0 || D > kMaxD || Dv <= 0 || Dv % 4 != 0 ||
      Dv > kMaxD || Skv < 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, Dv, scale,
                         causal, window, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, Dv,
                                 scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
