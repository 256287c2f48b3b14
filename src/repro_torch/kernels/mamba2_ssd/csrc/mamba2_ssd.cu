// mamba2_ssd for Hopper (sm_90a): the Mamba-2 SSD chunked scan.
//
// Replaces the TPU kernel mamba2_ssd in src/repro/kernels/mamba2_ssd/kernel.py:68
// (pl.pallas_call at :84), whose grid is (batch*heads, chunks) with the chunk
// axis sequential and the fp32 state h [N, P] carried in VMEM scratch. Per
// chunk of Q steps, with seg the within-chunk cumsum of dt*A:
//
//     y_i   = sum_{j<=i} (C_i . B_j) exp(seg_i - seg_j) x_j      (intra)
//           + exp(seg_i) (C_i . h)                               (inter)
//     h    <- exp(seg_last) h + sum_j exp(seg_last - seg_j) B_j^T x_j
//
// every exponent clipped to [-60, 0], x already multiplied by dt.
//
// Design. One CTA (256 threads) owns one (batch*head) row and loops over its
// chunks in order, in place of the TPU's sequential grid axis; h stays in
// shared memory for the whole row. A Q x Q fp32 score/decay tile does not fit
// (256 KB at Q = 256 against 227 KB), so a chunk is cut into 64-row strips of
// i: a strip's C rows are staged once, the inter term is taken from h, and the
// intra term walks the 64-key tiles j0 <= i0 (tiles above the diagonal are
// skipped), forming S = C B^T, masking and decaying it with
// exp(clip(seg_i - seg_j)) computed on the fly, and adding S x into the
// strip's accumulators. Each thread holds a 4 x (P/16) block of the strip's
// output and a 4 x 4 block of S in registers (rows ty + 16a, columns
// tx + 16b), so a shared-memory read feeds four products. After the strips,
// the state pass walks the chunk's key tiles again and updates h in place
// (h was read by every strip first). Everything is fp32 FMA: no tensor cores
// and no TF32, which keeps about three decimal digits where the function is
// held to 3e-6 of its largest output.
//
// B and C are shared by groups of heads (n_groups = 1 in Mamba-2): they come
// as [G, S, N] with G dividing BH, and row bh reads group bh / (BH / G). The
// model passes one group per batch row and no broadcast copy is made (the
// TPU path materialises B and C for every head).
//
// What bounds it on this card. The function reads x, B, C and seg and writes
// y once: 8 * BH * S * P + 8 * G * S * N + 4 * BH * S bytes. Its operations
// are, per row and chunk, Q^2 P for the causal intra product, 2 Q N P each
// for the inter term and the state (doubled for multiply and add), and
// Q^2 N for the shared scores once per group. At zamba2-7b's prefill
// (BH = 4 * 112, S = 2048, P = N = 64, Q = 256) that is about 0.48 GB and
// 30 GFLOP: 0.14 ms at 3.35 TB/s against 0.45 ms at 67 TFLOP/s of fp32, so
// the operations bound it. This kernel recomputes the scores for every head
// of a group and runs its FMAs out of shared memory on CUDA cores, one CTA
// per row (448 CTAs at that shape: under two waves of two CTAs per SM), so it
// sits an order of magnitude above that bound. What it leaves: sharing the
// scores across a group's heads, tensor cores (3xTF32 or bf16 splits that
// keep fp32 accuracy), and splitting a row's chunks across CTAs with a
// second pass for the state.
//
// Contract (checked by the launcher in kernel.py): fp32, contiguous;
// S % Q == 0; P a multiple of 16 up to 128; the shared memory of one CTA
// (computed below) within the card's 227 KB. The launch goes on the
// caller's stream and the function returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid of (ty, tx)
constexpr int kTile = 64;       // rows of a strip, keys of a tile
constexpr int kMaxColGroups = 8;  // P / 16 <= 8

__device__ __forceinline__ float clip_exp(float x) {
  return expf(fminf(fmaxf(x, -60.f), 0.f));
}

__global__ void __launch_bounds__(kThreads)
mamba2_ssd_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                  const float* __restrict__ cm, const float* __restrict__ seg,
                  float* __restrict__ y, int S, int P, int N, int heads_per_group,
                  int Q) {
  extern __shared__ float smem[];
  const int ldn = N | 1;                 // odd row stride: no bank conflicts
  float* hs = smem;                      // [N][P]  the carried state
  float* cs = hs + N * P;                // [kTile][ldn]  a strip's C rows
  float* bs = cs + kTile * ldn;          // [kTile][ldn]  a tile's B rows
  float* xs = bs + kTile * ldn;          // [kTile][P]    a tile's x rows
  float* ss = xs + kTile * P;            // [kTile][kTile + 1]  decayed scores
  float* segs = ss + kTile * (kTile + 1);  // [Q]  this chunk's seg
  float* ws = segs + Q;                  // [kTile]  exp(seg_last - seg_j)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long row = blockIdx.x;
  const long long grp = row / heads_per_group;
  const float* xr = x + row * S * P;
  const float* br = bm + grp * S * N;
  const float* cr = cm + grp * S * N;
  const float* sr = seg + row * S;
  float* yr = y + row * S * P;
  const int cgroups = P >> 4;            // column groups of 16

  for (int e = tid; e < N * P; e += kThreads) hs[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    __syncthreads();                     // h ready; last chunk's reads done
    for (int i = tid; i < Q; i += kThreads) segs[i] = sr[t0 + i];

    for (int i0 = 0; i0 < Q; i0 += kTile) {
      __syncthreads();                   // cs free, segs written
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int r = e / N, n = e - r * N;
        cs[r * ldn + n] = i0 + r < Q ? cr[(long long)(t0 + i0 + r) * N + n]
                                     : 0.f;
      }
      __syncthreads();

      // inter: exp(seg_i) * (C_i . h)
      float acc[4][kMaxColGroups];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < kMaxColGroups; ++b) acc[a][b] = 0.f;
      for (int n = 0; n < N; ++n) {
        float c[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) c[a] = cs[(ty + 16 * a) * ldn + n];
#pragma unroll
        for (int b = 0; b < kMaxColGroups; ++b) {
          if (b < cgroups) {
            const float hv = hs[n * P + tx + 16 * b];
#pragma unroll
            for (int a = 0; a < 4; ++a) acc[a][b] = fmaf(c[a], hv, acc[a][b]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        const float d = i < Q ? clip_exp(segs[i]) : 0.f;
#pragma unroll
        for (int b = 0; b < kMaxColGroups; ++b) acc[a][b] *= d;
      }

      // intra: the key tiles on or below the diagonal
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        __syncthreads();                 // bs, xs, ss free
        for (int e = tid; e < kTile * N; e += kThreads) {
          const int r = e / N, n = e - r * N;
          bs[r * ldn + n] = j0 + r < Q ? br[(long long)(t0 + j0 + r) * N + n]
                                       : 0.f;
        }
        for (int e = tid; e < kTile * P; e += kThreads) {
          const int r = e / P, p = e - r * P;
          xs[e] = j0 + r < Q ? xr[(long long)(t0 + j0 + r) * P + p] : 0.f;
        }
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
        for (int n = 0; n < N; ++n) {
          float c[4], bb[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            c[a] = cs[(ty + 16 * a) * ldn + n];
            bb[a] = bs[(tx + 16 * a) * ldn + n];
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) s[a][b] = fmaf(c[a], bb[b], s[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = j0 + tx + 16 * b;
            const bool seen = j <= i && i < Q;
            ss[(ty + 16 * a) * (kTile + 1) + tx + 16 * b] =
                seen ? s[a][b] * clip_exp(segs[i] - segs[j]) : 0.f;
          }
        }
        __syncthreads();
        for (int jj = 0; jj < kTile; ++jj) {
          float sv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) sv[a] = ss[(ty + 16 * a) * (kTile + 1) + jj];
#pragma unroll
          for (int b = 0; b < kMaxColGroups; ++b) {
            if (b < cgroups) {
              const float xv = xs[jj * P + tx + 16 * b];
#pragma unroll
              for (int a = 0; a < 4; ++a) acc[a][b] = fmaf(sv[a], xv, acc[a][b]);
            }
          }
        }
      }

#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        if (i < Q) {
#pragma unroll
          for (int b = 0; b < kMaxColGroups; ++b)
            if (b < cgroups) yr[(long long)(t0 + i) * P + tx + 16 * b] = acc[a][b];
        }
      }
    }

    // state: h <- exp(seg_last) h + sum_j exp(seg_last - seg_j) B_j^T x_j
    __syncthreads();                     // every strip has read h
    const float seg_last = segs[Q - 1];
    const float d_last = clip_exp(seg_last);
    for (int e = tid; e < N * P; e += kThreads) hs[e] *= d_last;
    for (int j0 = 0; j0 < Q; j0 += kTile) {
      __syncthreads();                   // bs, xs, ws free
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int r = e / N, n = e - r * N;
        bs[r * ldn + n] = j0 + r < Q ? br[(long long)(t0 + j0 + r) * N + n]
                                     : 0.f;
      }
      for (int e = tid; e < kTile * P; e += kThreads) {
        const int r = e / P, p = e - r * P;
        xs[e] = j0 + r < Q ? xr[(long long)(t0 + j0 + r) * P + p] : 0.f;
      }
      for (int r = tid; r < kTile; r += kThreads)
        ws[r] = j0 + r < Q ? clip_exp(seg_last - segs[j0 + r]) : 0.f;
      __syncthreads();
      for (int e = tid; e < N * P; e += kThreads) {
        const int n = e / P, p = e - n * P;
        float h = hs[e];
        for (int jj = 0; jj < kTile; ++jj)
          h = fmaf(bs[jj * ldn + n], ws[jj] * xs[jj * P + p], h);
        hs[e] = h;
      }
    }
  }
}

}  // namespace

// Bytes of dynamic shared memory one CTA needs (the launcher checks them
// against the card's limit before launching).
extern "C" int mamba2_ssd_smem_bytes(int P, int N, int Q) {
  const int ldn = N | 1;
  return static_cast<int>(sizeof(float)) *
         (N * P + 2 * kTile * ldn + kTile * P + kTile * (kTile + 1) + Q +
          kTile);
}

// x [BH, S, P], B and C [G, S, N] (G divides BH), seg [BH, S], y [BH, S, P],
// all fp32 and contiguous. Returns a cudaError_t (0 on success).
extern "C" int mamba2_ssd(const void* x, const void* bm, const void* cm,
                          const void* seg, void* y, int BH, int S, int P,
                          int N, int G, int Q, void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (Q <= 0 || S % Q != 0 || P <= 0 || P % 16 != 0 ||
      P > 16 * kMaxColGroups || N <= 0 || G <= 0 || BH % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = mamba2_ssd_smem_bytes(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      mamba2_ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mamba2_ssd_kernel<<<BH, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(seg),
      static_cast<float*>(y), S, P, N, BH / G, Q);
  return static_cast<int>(cudaGetLastError());
}
