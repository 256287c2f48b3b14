// flash_attention for Hopper (sm_90a): causal / sliding-window prefill
// attention with an fp32 online softmax.
//
// Replaces the TPU kernel flash_attention in
// src/repro/kernels/flash_attention/kernel.py:98 (pl.pallas_call at :128),
// which walks a (batch, head, q-block, kv-block) grid with the kv-block axis
// sequential and keeps the fp32 running max, sum and accumulator in VMEM
// across it. Here one CTA owns one (b, h, q tile) and a loop inside
// it takes the place of that sequential axis: it visits only the key tiles
// the causal / window band can reach (the TPU kernel's pl.when skip), so
// nothing is carried between CTAs.
//
// Semantics, as the reference: q [B, Hq, Sq, D]; k [B, Hkv, Skv, D] and
// v [B, Hkv, Skv, Dv], query head h reading KV head h / (Hq / Hkv) (the
// reference's repeated heads, without the copy); positions absolute from 0
// on both axes (k_pos <= q_pos even when Sq != Skv); a key is seen when
// k_pos < Skv, k_pos <= q_pos (causal) and k_pos > q_pos - window
// (window > 0). Scores are (q . k) * scale in fp32, masked ones the finite
// -1e30, never -inf. The output [B, Hq, Sq, Dv] is acc / max(l, 1e-30) in
// q's dtype. D and Dv multiples of 4 up to 128 (8 in bf16: the wrapper
// zero-pads other bf16 head dims).
//
// Layout. Every tensor comes with element strides for its batch, head and
// sequence axes (its last axis is contiguous), so the model's [B, S, H, D]
// projections are read in place and the output is written straight into a
// [B, S, Hq, Dv] buffer: no transposing copy on either side.
//
// Two bodies, chosen by dtype in the extern "C" dispatch at the end.
//
// fp32 (fa_f32_kernel): the fp32 model copies hold the card to the CPU at
// 2e-5, which TF32 would not keep, so fp32 stays on the CUDA cores. Four
// warps own eight query rows each; a 32-key tile is staged in shared memory
// (K rows padded by four floats against bank conflicts); each lane takes one
// key for the scores and four output columns for P.V, taking the eight rows'
// probabilities of key j from lane j by shuffle. A row whose first visited
// tile is fully masked accumulates garbage at m = -1e30 that the first real
// score wipes (alpha = 0).
//
// bf16 (fa_bf16_kernel), on the tensor cores with wgmma (FlashAttention-3's
// shape, without its ping-pong): a CTA owns one (b, h) and 128 query rows,
// the longest causal q tiles issued first. One producer warp keeps three
// 64-key K/V tiles in flight with TMA (a 4-D tensor map per operand over the
// strided [B, S, H, D] tensor; boxes of 64 columns land in the 128-byte
// swizzle wgmma reads, out-of-bounds rows and columns as zeros), guarded by
// full / empty mbarriers. Two consumer warpgroups own 64 rows each and never
// meet at a block barrier: S = Q K^T is wgmma.m64n64k16 with both operands
// in shared memory (K-major), the online softmax runs in fp32 on the
// accumulator fragments (a row is shared by a quad: max and sum are two
// shuffles; exp2 with the scale folded into one FMA; a masked key weighs
// exactly 0), and O += P V is wgmma.m64n64k16 with P in registers and V
// read MN-major from shared memory, 64 output columns at a time. Tiles
// wholly above a warpgroup's rows are released unread; only tiles across
// the causal diagonal, the window edge or Skv are masked.
//
// P is rounded twice, P = hi + lo with both halves in bf16, and P V is
// summed as lo V + hi V. One bf16 rounding of P alone puts an error of up
// to 2^-9 on every weight, which shows where outputs cancel towards zero:
// the limit the kernel is held to at the model's captured inputs (every
// element within 2^-6 |out| + 1e-4 max |out| of the fp32 definition)
// leaves no room for it there. The pair carries 16 bits of P. That doubles
// the P V products: two thirds of the tensor-core work instead of half.
//
// What bounds it on this card. The function needs 2 * (D + Dv) FLOPs for
// every (query, seen key) pair, about half the square when causal, and moves
// q, k, v and the output once. At zamba2-7b's prefill ([4, 32, 2048, 112]
// bf16, causal) that is 120 GFLOP against 235 MB: 0.12 ms on the bf16
// tensor cores (989 TFLOP/s) against 0.07 ms at 3.35 TB/s, so the
// operations bound it. What this kernel leaves: the second P V product,
// the padding of D and Dv to 64-column blocks (112 runs as 128), and the
// overlap of softmax with products. Two forms of the latter were tried
// and were slower on the card: issuing tile i + 1's scores before tile
// i's softmax (the extra score registers made ptxas serialise the wgmma
// pipeline), and taking turns between the warpgroups at named barriers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {            // element strides of batch, head and sequence
  long long b, h, s;
};

// ------------------------------------------------------------ fp32 body
constexpr int kWarps = 4;
constexpr int kRows = 8;                      // query rows per warp
constexpr int kBlockQ = kWarps * kRows;       // 32 rows a CTA
constexpr int kBlockKV = 32;                  // one key per lane

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
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

__global__ void __launch_bounds__(kWarps * 32)
fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              Strides qst, Strides kst, Strides vst, Strides ost, int Hq,
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
  const long long b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const float* qg = q + b * qst.b + h * qst.h;
  const float* kg = k + b * kst.b + hk * kst.h;
  const float* vg = v + b * vst.b + hk * vst.h;
  float* og = out + b * ost.b + h * ost.h;
  const int d4 = D / 4;
  const int dv4 = Dv / 4;

  for (int i = tid; i < kBlockQ * d4; i += kWarps * 32) {
    const int r = i / d4;
    const int c = (i - r * d4) * 4;
    const int qr = q0 + r;
    store4(qs + r * D + c, qr < Sq ? load4(qg + qr * qst.s + c)
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
      store4(ks + r * ldk + c, kr < Skv ? load4(kg + kr * kst.s + c)
                                        : make_float4(0.f, 0.f, 0.f, 0.f));
    }
    for (int i = tid; i < kBlockKV * dv4; i += kWarps * 32) {
      const int r = i / dv4;
      const int c = (i - r * dv4) * 4;
      const int kr = k0 + r;
      store4(vs + r * Dv + c, kr < Skv ? load4(vg + kr * vst.s + c)
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
      store4(og + qr * ost.s + lane * 4,
             make_float4(acc[r][0] / denom, acc[r][1] / denom,
                         acc[r][2] / denom, acc[r][3] / denom));
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out,
               const Strides* st, int B, int Hq, int Hkv, int Sq, int Skv,
               int D, int Dv, float scale, int causal, int window,
               cudaStream_t stream) {
  const int smem = (kBlockQ * D + kBlockKV * (D + 4) + kBlockKV * Dv) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fa_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, Hq, B);
  fa_f32_kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), st[0], st[1],
      st[2], st[3], Hq, Hkv, Sq, Skv, D, Dv, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ bf16 body
constexpr int kBM = 128;                      // query rows a CTA
constexpr int kBN = 64;                       // keys a tile
constexpr int kConsumers = 256;               // two warpgroups of 64 rows
constexpr int kBfThreads = kConsumers + 32;   // and one producer warp
constexpr int kSw = 64;                       // bf16 columns a swizzled row
constexpr int kStages = 3;                    // K/V tiles in flight

struct BfArgs {
  __nv_bfloat16* out;
  Strides os;
  int Hq, Hkv, Sq, Skv, Dv;
  float scale_log2;                           // scale * log2(e)
  int causal, window;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// arrives and announces `bytes` of copies that complete the phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// one TMA box of a [B, S, H, D] tensor map (coordinates innermost first:
// column, row, head, batch) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, int head, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
      "r"(b), "r"(smem_addr(bar))
      : "memory");
}

// a wgmma shared-memory descriptor of a 128-byte-swizzled tile: 8-row
// groups 1024 bytes apart (SBO); the LBO is 1024 bytes too, which is what
// the MN-major V operand's K direction steps by (one 64-column block per
// instruction, so no other stride is ever taken)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{1024 >> 4} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pins an accumulator's registers at this point: the compiler moves no
// read or write of them across it (around the asynchronous wgmma)
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// keeps A fragments a wgmma in flight reads alive (unmoved) until here
__device__ __forceinline__ void pin(uint32_t (&p)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(p[i][j])::"memory");
}

// d (m64n64, fp32) += A (shared, K-major) * B (shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(1));
}

// d (m64n64, fp32) += A (registers) * B (shared, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x0, x1) as a bf16 pair hi and the pair of what hi leaves, lo: hi + lo
// carries 16 bits of each value
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// O[:, c0 : c0 + NV] of this warpgroup's rows, normalised, to bf16 in
// global memory (accumulator element 4j + e at row g (+8 for e >= 2),
// column 8j + 2t + (e & 1))
template <int NR>
__device__ __forceinline__ void store_rows(const float (&o)[NR], int c0,
                                           __nv_bfloat16* og, long long ss,
                                           int qpos0, int Sq, int Dv,
                                           float inv0, float inv1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NR / 4; ++j) {
    const int c = c0 + j * 8 + 2 * t;
    if (c >= Dv) continue;
    if (qpos0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(og + qpos0 * ss + c) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (qpos0 + 8 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(og + (qpos0 + 8) * ss + c) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// One warpgroup's online softmax over one key tile: S (raw scores of
// 64 rows x 64 keys, element 4j + e at row g (+8 for e >= 2), key 8j + 2t +
// (e & 1)) becomes P, returned as two bf16 A fragments (hi + lo) per
// 16-key slice; the running max m and the quad-partial sums l take the
// tile in, and O is rescaled.
template <int VB>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], float (&o)[VB][32], float (&m)[2], float (&l)[2],
    uint32_t (&ph)[4][4], uint32_t (&pl)[4][4], const BfArgs& a, int k0,
    int qpos0, bool edge) {
  const int t = threadIdx.x & 3;
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    float x = s[e];                           // scaled in the exponent
    if (edge) {
      const int kpos = k0 + (e / 4) * 8 + 2 * t + (e & 1);
      const int qpos = (e & 2) ? qpos0 + 8 : qpos0;
      bool seen = kpos < a.Skv;
      if (a.causal) seen = seen && kpos <= qpos;
      if (a.window > 0) seen = seen && kpos > qpos - a.window;
      if (!seen) x = kNegInf;
    }
    s[e] = x;
    if (e & 2)
      mx1 = fmaxf(mx1, x);
    else
      mx0 = fmaxf(mx0, x);
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
  const float mn0 = fmaxf(m[0], mx0 * a.scale_log2);
  const float mn1 = fmaxf(m[1], mx1 * a.scale_log2);
  const float alpha0 = fast_exp2(m[0] - mn0), alpha1 = fast_exp2(m[1] - mn1);
  m[0] = mn0;
  m[1] = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    // a masked key gets exactly 0 (its exponent would be the rounding
    // residue of -1e30 * scale)
    const float p =
        fast_exp2(fmaf(s[e], a.scale_log2, -((e & 2) ? mn1 : mn0)));
    s[e] = edge && s[e] == kNegInf ? 0.f : p;
    if (e & 2)
      sum1 += s[e];
    else
      sum0 += s[e];
  }
  l[0] = l[0] * alpha0 + sum0;
  l[1] = l[1] * alpha1 + sum1;
#pragma unroll
  for (int vb = 0; vb < VB; ++vb)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[vb][e] *= (e & 2) ? alpha1 : alpha0;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split_bf16(s[8 * kk], s[8 * kk + 1], ph[kk][0], pl[kk][0]);
    split_bf16(s[8 * kk + 2], s[8 * kk + 3], ph[kk][1], pl[kk][1]);
    split_bf16(s[8 * kk + 4], s[8 * kk + 5], ph[kk][2], pl[kk][2]);
    split_bf16(s[8 * kk + 6], s[8 * kk + 7], ph[kk][3], pl[kk][3]);
  }
}

// issues S = Q K^T (this warpgroup's 64 rows, the tile's 64 keys) into s
template <int KD>
__device__ __forceinline__ void issue_scores(float (&s)[32],
                                             const __nv_bfloat16* qw,
                                             const __nv_bfloat16* kst) {
  constexpr int kQBlock = kBM * kSw, kKBlock = kBN * kSw;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
  pin(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int blk = kk / 4, w = (kk % 4) * 16;
    wgmma_ss_n64(s, sw128_desc(qw + blk * kQBlock + w),
                 sw128_desc(kst + blk * kKBlock + w));
  }
  wgmma_commit();
}

// issues O += P V with P's hi and lo fragments and V's 16-key slices
template <int VB>
__device__ __forceinline__ void issue_pv(float (&o)[VB][32],
                                         const uint32_t (&ph)[4][4],
                                         const uint32_t (&pl)[4][4],
                                         const __nv_bfloat16* vst) {
  constexpr int kKBlock = kBN * kSw;
#pragma unroll
  for (int vb = 0; vb < VB; ++vb) pin(o[vb]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int vb = 0; vb < VB; ++vb) {
      const uint64_t dv = sw128_desc(vst + vb * kKBlock + kk * 16 * kSw);
      wgmma_rs(o[vb], pl[kk], dv);
      wgmma_rs(o[vb], ph[kk], dv);
    }
  }
  wgmma_commit();
}

// KD: 16-column k-steps of Q K^T (D zero-padded to 16 KD); VB: 64-column
// blocks of V and of the output (Dv zero-padded to 64 VB). The instance is
// chosen from D and Dv at launch. Tiles are [rows][64] bf16 blocks, one per
// 64 columns, in the 128-byte swizzle (TMA writes it, wgmma reads it);
// columns past D and Dv, and rows past Sq and Skv, arrive as zeros (TMA's
// out-of-bounds fill).
template <int KD, int VB>
__global__ void __launch_bounds__(kBfThreads, 1)
fa_bf16_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const BfArgs a) {
  constexpr int KB = (KD + 3) / 4;            // 64-column blocks of Q and K
  constexpr int kQBlock = kBM * kSw, kKBlock = kBN * kSw;
  constexpr int kStageElems = (KB + VB) * kKBlock;
  extern __shared__ float4 smem4[];
  // 1024-byte aligned tiles (the swizzle's period)
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~uintptr_t{1023});
  __nv_bfloat16* kv = qs + KB * kQBlock;      // stages of K blocks, V blocks
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv + kStages * kStageElems);
  uint64_t* qfull = bars;                     // Q landed
  uint64_t* full = bars + 1;                  // [kStages] K/V landed
  uint64_t* empty = bars + 1 + kStages;       // [kStages] K/V consumed

  const int tid = threadIdx.x;
  const int nq = (a.Sq + kBM - 1) / kBM;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kBM;
  const int b = blockIdx.x / a.Hq;
  const int h = blockIdx.x % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);

  // the KV tiles the band can reach
  const int q_last = min(q0 + kBM, a.Sq) - 1;
  int kt_end = (a.Skv + kBN - 1) / kBN;
  if (a.causal) kt_end = min(kt_end, q_last / kBN + 1);
  int kt_begin = 0;
  if (a.window > 0) {
    const int lo = q0 - a.window + 1;         // first key any row can see
    kt_begin = lo > 0 ? lo / kBN : 0;
  }

  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warp: one lane keeps kStages K/V tiles in flight
    if (tid == kConsumers) {
      mbar_expect(qfull, KB * kQBlock * 2);
      for (int j = 0; j < KB; ++j)
        tma_load(qs + j * kQBlock, &tq, j * kSw, q0, h, b, qfull);
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int i = kt - kt_begin, st = i % kStages;
        if (i >= kStages) mbar_wait(empty + st, (i / kStages + 1) & 1);
        __nv_bfloat16* dst = kv + st * kStageElems;
        mbar_expect(full + st, kStageElems * 2);
        for (int j = 0; j < KB; ++j)
          tma_load(dst + j * kKBlock, &tk, j * kSw, kt * kBN, hk, b,
                   full + st);
        for (int j = 0; j < VB; ++j)
          tma_load(dst + (KB + j) * kKBlock, &tv, j * kSw, kt * kBN, hk, b,
                   full + st);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
  const int wg = tid >> 7;
  const int g = (tid & 31) >> 2;
  float o[VB][32];
#pragma unroll
  for (int vb = 0; vb < VB; ++vb)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[vb][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int qpos0 = q0 + 64 * wg + 16 * ((tid >> 5) & 3) + g;  // and + 8
  const int wg_first = q0 + 64 * wg, wg_last = wg_first + 63;
  // tiles wholly above this warpgroup's rows are released unread
  const int kt_own = a.causal ? min(kt_end, wg_last / kBN + 1) : kt_end;
  const __nv_bfloat16* qw = qs + 64 * wg * kSw;
  auto stage_of = [&](int kt) { return (kt - kt_begin) % kStages; };
  auto tiles_of = [&](int kt) { return kv + stage_of(kt) * kStageElems; };
  auto wait_tile = [&](int kt) {
    mbar_wait(full + stage_of(kt), ((kt - kt_begin) / kStages) & 1);
  };
  auto edge_of = [&](int k0) {
    return k0 + kBN > a.Skv || (a.causal && k0 + kBN - 1 > wg_first) ||
           (a.window > 0 && k0 <= wg_last - a.window);
  };
  mbar_wait(qfull, 0);

  float s[32];
  uint32_t ph[4][4], pl[4][4];                // the tile's P, hi and lo
  for (int kt = kt_begin; kt < kt_own; ++kt) {
    wait_tile(kt);
    issue_scores<KD>(s, qw, tiles_of(kt));
    wgmma_wait();
    pin(s);
    softmax_tile<VB>(s, o, m, l, ph, pl, a, kt * kBN, qpos0,
                     edge_of(kt * kBN));
    issue_pv<VB>(o, ph, pl, tiles_of(kt) + KB * kKBlock);
    wgmma_wait();
    pin(ph);
    pin(pl);
#pragma unroll
    for (int vb = 0; vb < VB; ++vb) pin(o[vb]);
    mbar_arrive(empty + stage_of(kt));        // this thread is done with it
  }
  // a skipped tile is released once it has landed: its fill follows every
  // release of the stage's previous tile, so the arrivals cannot count
  // toward that tile's phase
  for (int kt = max(kt_own, kt_begin); kt < kt_end; ++kt) {
    wait_tile(kt);
    mbar_arrive(empty + stage_of(kt));
  }

  l[0] += __shfl_xor_sync(kFull, l[0], 1);
  l[0] += __shfl_xor_sync(kFull, l[0], 2);
  l[1] += __shfl_xor_sync(kFull, l[1], 1);
  l[1] += __shfl_xor_sync(kFull, l[1], 2);
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  __nv_bfloat16* og = a.out + b * a.os.b + h * a.os.h;
#pragma unroll
  for (int vb = 0; vb < VB; ++vb)
    store_rows(o[vb], vb * kSw, og, a.os.s, qpos0, a.Sq, a.Dv, inv0, inv1);
}

template <int KD, int VB>
int launch_bf16_tiles(const CUtensorMap* maps, const BfArgs& a, int B,
                      cudaStream_t stream) {
  constexpr int KB = (KD + 3) / 4;
  const int smem = 1024 +
                   (kBM * kSw * KB + kStages * kBN * kSw * (KB + VB)) *
                       static_cast<int>(sizeof(__nv_bfloat16)) +
                   (1 + 2 * kStages) * static_cast<int>(sizeof(uint64_t));
  cudaError_t err = cudaFuncSetAttribute(
      fa_bf16_kernel<KD, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * a.Hq, (a.Sq + kBM - 1) / kBM);
  fa_bf16_kernel<KD, VB><<<grid, kBfThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], a);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (so the library links the runtime alone)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [B, S, H, cols] bf16 tensor (element strides st, columns contiguous)
// as a 4-D tensor map of [rows][64] boxes in the 128-byte swizzle
bool make_map(CUtensorMap* map, const void* base, int B, int S, int H,
              int cols, Strides st, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const long long span = 2LL * cols;
  // a stride of an axis of one element is never taken: any valid one
  auto bytes = [&](long long stride, int n) -> cuuint64_t {
    return n > 1 ? 2 * stride : 16 * ((span * S * H * B + 15) / 16);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(st.s, S), bytes(st.h, H),
                                 bytes(st.b, B)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kSw),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16: D and Dv multiples of 8, every stride of an axis longer than one a
// multiple of 8 elements and every base 16-byte aligned (TMA's terms; the
// wrapper pads and copies what does not meet them)
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                const Strides* st, int B, int Hq, int Hkv, int Sq, int Skv,
                int D, int Dv, float scale, int causal, int window,
                cudaStream_t stream) {
  if (D % 8 != 0 || Dv % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  if (!make_map(&maps[0], q, B, Sq, Hq, D, st[0], kBM) ||
      !make_map(&maps[1], k, B, Skv, Hkv, D, st[1], kBN) ||
      !make_map(&maps[2], v, B, Skv, Hkv, Dv, st[2], kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  BfArgs a;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.os = st[3];
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Skv = Skv;
  a.Dv = Dv;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.causal = causal;
  a.window = window;
  // the model configs' head dims get their own instance; any other shape
  // runs zero-padded to 128. MLA's (96, 64) (minicpm3: nope 64 + rope 32
  // for q and k, v 64) takes six 16-column k-steps, the second 64-column
  // box of Q and K zero-filled past column 96 by TMA, and one V block
  if (D <= 64 && D > 48 && Dv <= 64)
    return launch_bf16_tiles<4, 1>(maps, a, B, stream);
  if (D <= 96 && D > 64 && Dv <= 64)
    return launch_bf16_tiles<6, 1>(maps, a, B, stream);
  if (D <= 112 && D > 96)
    return launch_bf16_tiles<7, 2>(maps, a, B, stream);
  return launch_bf16_tiles<8, 2>(maps, a, B, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, (batch,
// head, sequence) of q, k, v and out in that order; the last axis of each
// is contiguous, every stride a multiple of 4 and every base 16-byte
// aligned (the caller checks). Returns a cudaError_t (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, const long long* strides, int B,
                               int Hq, int Hkv, int Sq, int Skv, int D,
                               int Dv, float scale, int causal, int window,
                               int dtype, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (D <= 0 || D % 4 != 0 || D > kMaxD || Dv <= 0 || Dv % 4 != 0 ||
      Dv > kMaxD || Skv < 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k, v, out, st, B, Hq, Hkv, Sq, Skv, D, Dv, scale,
                      causal, window, s);
  if (dtype == 1)
    return launch_bf16(q, k, v, out, st, B, Hq, Hkv, Sq, Skv, D, Dv, scale,
                       causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
