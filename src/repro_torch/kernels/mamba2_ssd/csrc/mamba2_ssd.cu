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
// Design: the three passes of the chunked form, each a kernel, launched in
// order on one stream. On the TPU the chunk axis is a sequential grid axis;
// here only the cheap middle pass is sequential, so every chunk of every
// row is work for its own CTAs.
//
//   1. chunk_state, grid (row, chunk): s_c = sum_j exp(seg_last - seg_j)
//      B_j^T x_j, an [N, P] fp32 matrix per row and chunk, for every chunk
//      but the last (whose state nothing reads). 32-key tiles of B and x
//      are double-buffered through shared memory with cp.async; the decay
//      is applied to the A operand (B^T) as it is read.
//   2. state_pass, grid (row, N*P / 1024): h_{c+1} = exp(seg_last,c) h_c +
//      s_c, h_0 = 0, in place over the chunk states, a float4 a thread, so
//      slot c ends up holding the state that enters chunk c + 1.
//   3. chunk_scan, grid (64-row strip, group x block of 8 heads, chunk),
//      the strips of one block side by side so that they read its x and h
//      from L2 together: the strip's scores C_i . B_j (j <= the strip's
//      last row) are formed once into shared memory and applied to every
//      head of the block, because all the heads of a group share B and C
//      (zamba2: 112 heads a group); only the decay exp(seg_i - seg_j) is per
//      head, applied as the A operand is read. The inter term is C_strip h
//      with h from pass 2.
//
// In passes 1 and 3 a warp owns one 16-row m-tile and all P columns (P / 8
// n-tiles, P up to 64), and the warps that share an m-tile split the
// k-steps between them; their partial sums meet in shared memory. Every
// matrix product (the chunk states, the scores, the inter term and the
// intra term) runs on the tensor cores as 3xTF32: each fp32 operand is
// split into a TF32 hi part and the rest, lo, and mma.sync.m16n8k8 sums
// lo*hi + hi*lo + hi*hi into fp32 accumulators, in three rounds over the
// n-tiles so that two products into one accumulator are P / 8 instructions
// apart. The dropped lo*lo term is below 2^-21 of a product, so the result
// keeps the fp32 FMA kernel's accuracy (held to 3e-6 of the largest
// output). Shared rows are padded so that every fragment read is free of
// bank conflicts: rows read as [m][k] have a leading dimension of 4 mod 8
// words, rows read as [k][n] one of 8 mod 16.
//
// B and C are shared by groups of heads: they come as [G, S, N] with G
// dividing BH, and row bh reads group bh / (BH / G); no broadcast copy is
// made (the TPU path materialises B and C for every head).
//
// What bounds it on this card. The function reads x, B, C and seg and writes
// y once: 8 * BH * S * P + 8 * G * S * N + 4 * BH * S bytes. Its operations
// are, per row and chunk, Q^2 P for the causal intra product, 2 Q N P each
// for the inter term and the state (doubled for multiply and add), and
// Q^2 N for the shared scores once per group. At zamba2-7b's prefill
// (BH = 4 * 112, S = 2048, P = N = 64, Q = 256) that is about 0.48 GB and
// 30 GFLOP: 0.14 ms at 3.35 TB/s against 0.45 ms at 67 TFLOP/s of fp32 and
// 0.18 ms at a third of the 495 TFLOP/s TF32 rate (three products for one),
// so the operations bound it. The chunk states add 2 * BH * (S/Q - 1) * N * P
// * 4 bytes written and read twice (51 MB at that shape).
//
// Contract (checked by the launcher in kernel.py): fp32, contiguous;
// S % Q == 0; P a multiple of 16 up to 64; N a multiple of 4 up to 128;
// the shared memory of one CTA (mamba2_ssd_smem_bytes) within the card's
// 227 KB. The launches go on the caller's stream and each entry point
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // eight warps
constexpr int kWarps = 8;
constexpr int kStrip = 64;      // rows of a chunk_scan strip
constexpr int kKT = 32;         // keys of a staged tile
constexpr int kHeadsPerCta = 8; // heads of one group a chunk_scan CTA takes
constexpr int kMaxN = 128;      // the state
constexpr int kMaxP = 64;       // the head dim: P / 8 n-tiles a warp

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
// leading dimensions (words) of rows read as [m][k] (4 mod 8) and as
// [k][n] (8 mod 16): no bank conflicts in the fragment reads
__host__ __device__ __forceinline__ int ld_mk(int cols) {
  return round_up(cols, 8) + 4;
}
__host__ __device__ __forceinline__ int ld_kn(int cols) {
  return round_up(cols, 16) + 8;
}

__device__ __forceinline__ float clip_exp(float x) {
  return expf(fminf(fmaxf(x, -60.f), 0.f));
}

constexpr float kLog2e = 1.4426950408889634f;

// exp(clip(x)) as one ex2.approx of x * log2(e) (relative error about
// 2^-22). x must be the difference itself: scaling seg_i and seg_j apart
// before subtracting them would round each (|seg| reaches 60 and more)
__device__ __forceinline__ float fast_clip_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(y)
      : "f"(fminf(fmaxf(x, -60.f), 0.f) * kLog2e));
  return y;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as hi + lo: hi rounded to TF32, lo = x - hi exactly in fp32 (the
// tensor core reads lo's top 19 bits: below 2^-21 of x is dropped)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 8, row) of four fp32 values, split into hi and lo
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// one 16-byte copy global -> shared; invalid copies write zeros
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// issues the copies of rows [0, nrows) x columns [0, cols) (cols a
// multiple of 4) of a tile whose row r is src + r * src_ld; rows >=
// rows_valid are written as zeros, columns past cols are not touched
__device__ __forceinline__ void stage_async(float* dst, int ld,
                                            const float* src, long long src_ld,
                                            int nrows, int rows_valid,
                                            int cols) {
  const int per_row = cols / 4;
  for (int e = threadIdx.x; e < nrows * per_row; e += kThreads) {
    const int r = e / per_row;
    const int c = (e - r * per_row) * 4;
    const bool valid = r < rows_valid;
    cp16(dst + r * ld + c, valid ? src + r * src_ld + c : src, valid);
  }
}

// zeros columns [c0, c1) of rows [0, nrows)
__device__ __forceinline__ void zero_cols(float* dst, int ld, int nrows,
                                          int c0, int c1) {
  const int w = c1 - c0;
  if (w <= 0) return;
  for (int e = threadIdx.x; e < nrows * w; e += kThreads)
    dst[(e / w) * ld + c0 + e % w] = 0.f;
}

// ---------------------------------------------------------- pass 1
// d += a * b in 3xTF32 over NT n-tiles sharing one A fragment; b0 / b1
// hold each n-tile's two B values. The three products go in three rounds
// over the n-tiles, so that two products into one accumulator are NT
// instructions apart
template <int NT>
__device__ __forceinline__ void mma3_row(float (&d)[NT][4], const FragA& a,
                                         const float (&b0)[NT],
                                         const float (&b1)[NT]) {
  uint32_t bh0[NT], bl0[NT], bh1[NT], bl1[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    split(b0[n], bh0[n], bl0[n]);
    split(b1[n], bh1[n], bl1[n]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(d[n], a.lo, bh0[n], bh1[n]);
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(d[n], a.hi, bl0[n], bl1[n]);
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(d[n], a.hi, bh0[n], bh1[n]);
}

// the 16 x P fragment of a warp into rows [row0, row0 + 16) of a [rows][P]
// fp32 array
template <int NT>
__device__ __forceinline__ void store_rows(float* dst, int row0,
                                           const float (&d)[NT][4]) {
  constexpr int P = NT * 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float* o = dst + (row0 + g) * P + n * 8 + 2 * t;
    *reinterpret_cast<float2*>(o) = make_float2(d[n][0], d[n][1]);
    *reinterpret_cast<float2*>(o + 8 * P) = make_float2(d[n][2], d[n][3]);
  }
}

struct StateLayout {
  int ldb, ldx, qpad;
  int ws, bs, xs, red, total;            // offsets and size in floats
  __host__ __device__ StateLayout(int P, int N, int Q) {
    ldb = ld_kn(N);
    ldx = ld_kn(P);
    qpad = round_up(Q, kKT);
    ws = 0;
    bs = ws + qpad;
    xs = bs + 2 * kKT * ldb;
    red = bs;                            // after the last tile
    const int tiles = 2 * kKT * (ldb + ldx), reduce = 8 * 16 * P;
    total = bs + (tiles > reduce ? tiles : reduce);
  }
};

// states[bh, c] = sum_j exp(clip(seg_last - seg_j)) B_j^T x_j, c < nc - 1.
// Key tiles of B and x double-buffered with cp.async, the decay applied to
// the A operand (B^T) as it is read. Warp w owns m-tile w % MTP of the
// state's rows (MTP = the m-tiles rounded up to a power of two) and every
// KS-th k-step (KS = 8 / MTP); the KS partial sums meet in shared memory.
template <int NT>
__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                   const float* __restrict__ seg, float* __restrict__ states,
                   int S, int N, int heads_per_group, int Q) {
  constexpr int P = NT * 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const StateLayout L(P, N, Q);
  const int ldb = L.ldb, ldx = L.ldx, npad = round_up(N, 16);
  float* ws = smem + L.ws;               // [qpad]  exp(seg_last - seg_j)
  float* bs = smem + L.bs;               // 2 x [kKT][ldb]  B_j (A = B^T)
  float* xs = smem + L.xs;               // 2 x [kKT][ldx]  x_j
  float* red = smem + L.red;             // [KS][MTP * 16][P]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = blockIdx.x;
  const int c = blockIdx.y;
  const int nc1 = gridDim.y;             // chunks with a state (nc - 1)
  const long long t0 = static_cast<long long>(c) * Q;
  const float* xr = x + (bh * S + t0) * P;
  const float* br = bm + ((bh / heads_per_group) * S + t0) * N;
  const float* sr = seg + bh * S + t0;
  const int mtiles = npad / 16;
  const int mtp = mtiles <= 1 ? 1 : mtiles <= 2 ? 2 : mtiles <= 4 ? 4 : 8;
  const int ks = kWarps / mtp;
  const int mt = warp % mtp, kh = warp / mtp;
  const bool active = mt < mtiles;

  zero_cols(bs, ldb, 2 * kKT, N, npad);  // the copies never write these
  stage_async(bs, ldb, br, N, kKT, Q, N);
  stage_async(xs, ldx, xr, P, kKT, Q, P);
  cp_commit();
  const float seg_last = sr[Q - 1];
  for (int j = tid; j < L.qpad; j += kThreads)
    ws[j] = j < Q ? clip_exp(seg_last - sr[j]) : 0.f;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int ntiles = L.qpad / kKT;
  for (int it = 0; it < ntiles; ++it) {
    const int j0 = it * kKT;
    const int stage = it & 1;
    cp_wait_all();
    __syncthreads();                     // tile it landed; it - 1 consumed
    if (it + 1 < ntiles) {
      stage_async(bs + (stage ^ 1) * kKT * ldb, ldb, br + (j0 + kKT) * N, N,
                  kKT, Q - j0 - kKT, N);
      stage_async(xs + (stage ^ 1) * kKT * ldx, ldx, xr + (j0 + kKT) * P, P,
                  kKT, Q - j0 - kKT, P);
    }
    cp_commit();
    const float* bt = bs + stage * kKT * ldb;
    const float* xt = xs + stage * kKT * ldx;
#pragma unroll
    for (int kk = 0; kk < kKT; kk += 8) {
      if (!active || ((j0 + kk) / 8) % ks != kh) continue;
      const float* b0 = bt + (kk + t) * ldb + mt * 16 + g;
      const float* b4 = b0 + 4 * ldb;
      const float w0 = ws[j0 + kk + t], w4 = ws[j0 + kk + t + 4];
      FragA a;
      a.set(b0[0] * w0, b0[8] * w0, b4[0] * w4, b4[8] * w4);
      const float* x0 = xt + (kk + t) * ldx + g;
      const float* x4 = x0 + 4 * ldx;
      float v0[NT], v4[NT];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        v0[n] = x0[n * 8];
        v4[n] = x4[n * 8];
      }
      mma3_row<NT>(acc, a, v0, v4);
    }
  }
  cp_wait_all();
  __syncthreads();                       // the tiles are free for red
  if (active) store_rows<NT>(red, (kh * mtp + mt) * 16, acc);
  __syncthreads();
  float* out = states + (bh * nc1 + c) * static_cast<long long>(N) * P;
  for (int e = tid * 4; e < N * P; e += kThreads * 4) {
    float4 sum = *reinterpret_cast<const float4*>(red + e);
    for (int k = 1; k < ks; ++k) {
      const float4 v =
          *reinterpret_cast<const float4*>(red + k * mtp * 16 * P + e);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    *reinterpret_cast<float4*>(out + e) = sum;
  }
}

// ---------------------------------------------------------- pass 2
// in place: slot c <- h_{c+1} = exp(clip(seg_last,c)) h_c + s_c, h_0 = 0
__global__ void __launch_bounds__(kThreads)
state_pass_kernel(const float* __restrict__ seg, float* __restrict__ states,
                  int S, int NP, int Q, int nc1) {
  const long long bh = blockIdx.x;
  const int e = (blockIdx.y * kThreads + threadIdx.x) * 4;
  if (e >= NP) return;
  float4* slot = reinterpret_cast<float4*>(states + bh * nc1 * NP + e);
  const float* sr = seg + bh * S + Q - 1;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc1; ++c) {
    const float d = clip_exp(sr[static_cast<long long>(c) * Q]);
    const float4 s = slot[static_cast<long long>(c) * (NP / 4)];
    h = make_float4(fmaf(d, h.x, s.x), fmaf(d, h.y, s.y), fmaf(d, h.z, s.z),
                    fmaf(d, h.w, s.w));
    slot[static_cast<long long>(c) * (NP / 4)] = h;
  }
}

// ---------------------------------------------------------- pass 3
struct ScanLayout {
  int ldc, ldcb, ldx, npad8, qpad;
  int cs, cb, r0, r1, segs, total;       // offsets and size in floats
  __host__ __device__ ScanLayout(int P, int N, int Q) {
    ldc = ld_mk(N);
    qpad = round_up(Q, kKT);
    ldcb = qpad + 4;                     // 4 mod 8: read as [i][j]
    ldx = ld_kn(P);
    npad8 = round_up(N, 8);
    const int tile = kKT * (ldc > ldx ? ldc : ldx);
    int big = npad8 * ldx;               // a head's h, or the partial sums
    if (big < tile) big = tile;
    if (big < kStrip * P) big = kStrip * P;
    cs = 0;
    cb = cs + kStrip * ldc;
    r0 = cb + kStrip * ldcb;             // a B or x tile
    r1 = r0 + tile;                      // a B or x tile, h, partial sums
    segs = r1 + big;
    total = segs + qpad;
  }
};

// y for a 64-row strip of a chunk and a block of heads of one group. Warp
// w owns m-tile w % 4 of the strip (all P columns) and the k-steps of
// parity w / 4; the two partial sums of an m-tile meet in shared memory
template <int NT>
__global__ void __launch_bounds__(kThreads)
chunk_scan_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                  const float* __restrict__ cm, const float* __restrict__ seg,
                  const float* __restrict__ states, float* __restrict__ y,
                  int S, int N, int heads_per_group, int Q) {
  constexpr int P = NT * 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const ScanLayout L(P, N, Q);
  float* cs = smem + L.cs;               // [kStrip][ldc]   C_i
  float* cb = smem + L.cb;               // [kStrip][ldcb]  C_i . B_j
  float* const r0 = smem + L.r0;         // a B or x tile
  float* const r1 = smem + L.r1;         // the other one, or h, or sums
  float* hs = smem + L.r1;               // [npad8][ldx]    h entering chunk
  float* red = smem + L.r1;              // [kStrip][P]     partial sums
  float* segs = smem + L.segs;           // [qpad]          a head's seg

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int hblocks = (heads_per_group + kHeadsPerCta - 1) / kHeadsPerCta;
  const long long grp = blockIdx.y / hblocks;
  const int hb = blockIdx.y % hblocks;
  const int c = blockIdx.z;
  const int nc = gridDim.z;
  const int i0 = blockIdx.x * kStrip;
  const int jn = min(Q, i0 + kStrip);    // keys the strip can see
  const int ntiles = (jn + kKT - 1) / kKT;
  const long long t0 = static_cast<long long>(c) * Q;
  const int h_begin = hb * kHeadsPerCta;
  const int h_end = min(heads_per_group, h_begin + kHeadsPerCta);
  const float* bg = bm + (grp * S + t0) * N;

  // the strip's C rows, then its scores against B's key tiles (double
  // buffered), once for all heads
  zero_cols(cs, L.ldc, kStrip, N, L.npad8);      // never copied
  zero_cols(r0, L.ldc, kKT, N, L.npad8);
  zero_cols(r1, L.ldc, kKT, N, L.npad8);
  stage_async(cs, L.ldc, cm + (grp * S + t0 + i0) * N, N, kStrip, Q - i0, N);
  stage_async(r0, L.ldc, bg, N, kKT, Q, N);
  cp_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int j0 = it * kKT;
    cp_wait_all();
    __syncthreads();                     // tile it landed; it - 1 consumed
    if (it + 1 < ntiles)
      stage_async(((it + 1) & 1 ? r1 : r0), L.ldc, bg + (j0 + kKT) * N, N, kKT,
                  Q - j0 - kKT, N);
    cp_commit();
    const float* bt = (it & 1 ? r1 : r0);
    // 4 m-tiles x 4 n-tiles of keys: m-tiles w / 4 and w / 4 + 2, n-tile
    // w % 4
    const int jl = (warp & 3) * 8;
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kk = 0; kk < L.npad8; kk += 8) {
      const float* bj = bt + (jl + g) * L.ldc + kk + t;
      uint32_t bh0, bl0, bh1, bl1;
      split(bj[0], bh0, bl0);
      split(bj[4], bh1, bl1);
      FragA a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* c0 = cs + ((warp >> 2) * 16 + i * 32 + g) * L.ldc + kk + t;
        const float* c8 = c0 + 8 * L.ldc;
        a[i].set(c0[0], c8[0], c0[4], c8[4]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_tf32(d[i], a[i].lo, bh0, bh1);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_tf32(d[i], a[i].hi, bl0, bl1);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_tf32(d[i], a[i].hi, bh0, bh1);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* o = cb + ((warp >> 2) * 16 + i * 32 + g) * L.ldcb + j0 + jl + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(d[i][0], d[i][1]);
      *reinterpret_cast<float2*>(o + 8 * L.ldcb) = make_float2(d[i][2], d[i][3]);
    }
  }

  const int mt = (warp & 3) * 16, kh = warp >> 2;
  const int ia = i0 + mt + g, ib = ia + 8;       // this lane's two rows
  for (int hh = h_begin; hh < h_end; ++hh) {
    const long long bh = grp * heads_per_group + hh;
    const float* xr = x + (bh * S + t0) * P;
    __syncthreads();                     // the last phase done with smem
    if (c > 0) {
      // rows [N, npad8) of h are zeros the copies never write
      for (int e = tid; e < (L.npad8 - N) * P; e += kThreads)
        hs[(N + e / P) * L.ldx + e % P] = 0.f;
      stage_async(hs, L.ldx,
                  states + (bh * (nc - 1) + c - 1) * static_cast<long long>(N) * P,
                  P, N, N, P);
    }
    stage_async(r0, L.ldx, xr, P, kKT, Q, P);
    cp_commit();
    for (int j = tid; j < jn; j += kThreads) segs[j] = seg[bh * S + t0 + j];
    cp_wait_all();
    __syncthreads();

    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const float sa = ia < Q ? segs[ia] : 0.f;
    const float sb = ib < Q ? segs[ib] : 0.f;

    // inter: exp(seg_i) (C_i . h)
    if (c > 0) {
      for (int kk = kh * 8; kk < L.npad8; kk += 16) {
        const float* c0 = cs + (mt + g) * L.ldc + kk + t;
        const float* c8 = c0 + 8 * L.ldc;
        FragA a;
        a.set(c0[0], c8[0], c0[4], c8[4]);
        const float* h0 = hs + (kk + t) * L.ldx + g;
        const float* h4 = h0 + 4 * L.ldx;
        float v0[NT], v4[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          v0[n] = h0[n * 8];
          v4[n] = h4[n * 8];
        }
        mma3_row<NT>(acc, a, v0, v4);
      }
      const float e0 = ia < Q ? fast_clip_exp(sa) : 0.f;
      const float e8 = ib < Q ? fast_clip_exp(sb) : 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= e0;
        acc[n][1] *= e0;
        acc[n][2] *= e8;
        acc[n][3] *= e8;
      }
    }

    // intra: sum_{j <= i} (C_i . B_j) exp(seg_i - seg_j) x_j, x's key
    // tiles double-buffered (the first one into region 0, the next into
    // region 1 once h there is read)
    const float* cba = cb + (mt + g) * L.ldcb;
    const float* cbb = cba + 8 * L.ldcb;
    for (int it = 0; it < ntiles; ++it) {
      const int j0 = it * kKT;
      cp_wait_all();
      __syncthreads();                   // tile it landed; it - 1 consumed
      if (it + 1 < ntiles)
        stage_async(((it + 1) & 1 ? r1 : r0), L.ldx, xr + (j0 + kKT) * P, P, kKT,
                    Q - j0 - kKT, P);
      cp_commit();
      const float* xt = (it & 1 ? r1 : r0);
#pragma unroll
      for (int kk = kh * 8; kk < kKT; kk += 16) {
        if (j0 + kk > i0 + mt + 15) break;         // above the diagonal
        const int j = j0 + kk + t;
        const float s0 = segs[min(j, jn - 1)];
        const float s4 = segs[min(j + 4, jn - 1)];
        FragA a;
        a.set(j <= ia && ia < Q ? cba[j] * fast_clip_exp(sa - s0) : 0.f,
              j <= ib && ib < Q ? cbb[j] * fast_clip_exp(sb - s0) : 0.f,
              j + 4 <= ia && ia < Q ? cba[j + 4] * fast_clip_exp(sa - s4) : 0.f,
              j + 4 <= ib && ib < Q ? cbb[j + 4] * fast_clip_exp(sb - s4) : 0.f);
        const float* x0 = xt + (kk + t) * L.ldx + g;
        const float* x4 = x0 + 4 * L.ldx;
        float v0[NT], v4[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          v0[n] = x0[n * 8];
          v4[n] = x4[n * 8];
        }
        mma3_row<NT>(acc, a, v0, v4);
      }
    }

    // the two halves of each m-tile meet; the even half writes y
    __syncthreads();                     // every tile consumed: r1 free
    if (kh == 1) store_rows<NT>(red, mt, acc);
    __syncthreads();
    if (kh == 0) {
      float* yr = y + (bh * S + t0 + i0) * P;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n * 8 + 2 * t;
        const float* r = red + (mt + g) * P + col;
        if (ia < Q)
          *reinterpret_cast<float2*>(yr + (mt + g) * P + col) =
              make_float2(acc[n][0] + r[0], acc[n][1] + r[1]);
        if (ib < Q)
          *reinterpret_cast<float2*>(yr + (mt + g + 8) * P + col) =
              make_float2(acc[n][2] + r[8 * P], acc[n][3] + r[8 * P + 1]);
      }
    }
  }
  cp_wait_all();
}

bool bad_shape(int BH, int S, int P, int N, int G, int Q) {
  return Q <= 0 || S % Q != 0 || P <= 0 || P % 16 != 0 || P > kMaxP ||
         N <= 0 || N % 4 != 0 || N > kMaxN || G <= 0 || BH % G != 0;
}

template <int NT>
int launch_state_nt(const float* x, const float* bm, const float* seg,
                    float* states, int BH, int S, int N, int G, int Q,
                    cudaStream_t stream) {
  const int smem =
      StateLayout(NT * 8, N, Q).total * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      chunk_state_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_state_kernel<NT><<<dim3(BH, S / Q - 1), kThreads, smem, stream>>>(
      x, bm, seg, states, S, N, BH / G, Q);
  return static_cast<int>(cudaGetLastError());
}

int launch_state(const float* x, const float* bm, const float* seg,
                 float* states, int BH, int S, int P, int N, int G, int Q,
                 cudaStream_t stream) {
  if (S / Q - 1 == 0) return 0;
  switch (P / 8) {
    case 2: return launch_state_nt<2>(x, bm, seg, states, BH, S, N, G, Q, stream);
    case 4: return launch_state_nt<4>(x, bm, seg, states, BH, S, N, G, Q, stream);
    case 6: return launch_state_nt<6>(x, bm, seg, states, BH, S, N, G, Q, stream);
    default: return launch_state_nt<8>(x, bm, seg, states, BH, S, N, G, Q, stream);
  }
}

int launch_pass(const float* seg, float* states, int BH, int S, int P, int N,
                int Q, cudaStream_t stream) {
  const int nc1 = S / Q - 1;
  if (nc1 == 0) return 0;
  const int NP = N * P;
  state_pass_kernel<<<dim3(BH, (NP / 4 + kThreads - 1) / kThreads), kThreads,
                      0, stream>>>(seg, states, S, NP, Q, nc1);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_scan_nt(const float* x, const float* bm, const float* cm,
                   const float* seg, const float* states, float* y, int BH,
                   int S, int N, int G, int Q, cudaStream_t stream) {
  const int smem =
      ScanLayout(NT * 8, N, Q).total * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      chunk_scan_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hpg = BH / G;
  // the strips of one (block of heads, chunk) side by side, so that they
  // read its x and h from L2 together
  const dim3 grid((Q + kStrip - 1) / kStrip,
                  G * ((hpg + kHeadsPerCta - 1) / kHeadsPerCta), S / Q);
  chunk_scan_kernel<NT><<<grid, kThreads, smem, stream>>>(
      x, bm, cm, seg, states, y, S, N, hpg, Q);
  return static_cast<int>(cudaGetLastError());
}

int launch_scan(const float* x, const float* bm, const float* cm,
                const float* seg, const float* states, float* y, int BH,
                int S, int P, int N, int G, int Q, cudaStream_t stream) {
  switch (P / 8) {
    case 2: return launch_scan_nt<2>(x, bm, cm, seg, states, y, BH, S, N, G, Q, stream);
    case 4: return launch_scan_nt<4>(x, bm, cm, seg, states, y, BH, S, N, G, Q, stream);
    case 6: return launch_scan_nt<6>(x, bm, cm, seg, states, y, BH, S, N, G, Q, stream);
    default: return launch_scan_nt<8>(x, bm, cm, seg, states, y, BH, S, N, G, Q, stream);
  }
}

}  // namespace

// Bytes of dynamic shared memory the largest of the passes needs (the
// launcher checks them against the card's limit before launching).
extern "C" int mamba2_ssd_smem_bytes(int P, int N, int Q) {
  const int scan = ScanLayout(P, N, Q).total * static_cast<int>(sizeof(float));
  const int state =
      StateLayout(P, N, Q).total * static_cast<int>(sizeof(float));
  return scan > state ? scan : state;
}

// The passes one by one (the wrapper's tests hold each against its plain
// version). x [BH, S, P], B and C [G, S, N] (G divides BH), seg [BH, S],
// states [BH, S/Q - 1, N, P], y [BH, S, P], all fp32 and contiguous.
// Each returns a cudaError_t (0 on success).
extern "C" int mamba2_ssd_chunk_state(const void* x, const void* bm,
                                      const void* seg, void* states, int BH,
                                      int S, int P, int N, int G, int Q,
                                      void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (bad_shape(BH, S, P, N, G, Q)) return cudaErrorInvalidValue;
  return launch_state(static_cast<const float*>(x),
                      static_cast<const float*>(bm),
                      static_cast<const float*>(seg),
                      static_cast<float*>(states), BH, S, P, N, G, Q,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int mamba2_ssd_state_pass(const void* seg, void* states, int BH,
                                     int S, int P, int N, int Q,
                                     void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (bad_shape(BH, S, P, N, 1, Q)) return cudaErrorInvalidValue;
  return launch_pass(static_cast<const float*>(seg),
                     static_cast<float*>(states), BH, S, P, N, Q,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int mamba2_ssd_chunk_scan(const void* x, const void* bm,
                                     const void* cm, const void* seg,
                                     const void* states, void* y, int BH,
                                     int S, int P, int N, int G, int Q,
                                     void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  if (bad_shape(BH, S, P, N, G, Q)) return cudaErrorInvalidValue;
  return launch_scan(static_cast<const float*>(x),
                     static_cast<const float*>(bm),
                     static_cast<const float*>(cm),
                     static_cast<const float*>(seg),
                     static_cast<const float*>(states),
                     static_cast<float*>(y), BH, S, P, N, G, Q,
                     static_cast<cudaStream_t>(stream));
}

// The whole scan: the three passes in order on one stream.
extern "C" int mamba2_ssd(const void* x, const void* bm, const void* cm,
                          const void* seg, void* states, void* y, int BH,
                          int S, int P, int N, int G, int Q, void* stream) {
  int err = mamba2_ssd_chunk_state(x, bm, seg, states, BH, S, P, N, G, Q,
                                   stream);
  if (err != 0) return err;
  err = mamba2_ssd_state_pass(seg, states, BH, S, P, N, Q, stream);
  if (err != 0) return err;
  return mamba2_ssd_chunk_scan(x, bm, cm, seg, states, y, BH, S, P, N, G, Q,
                               stream);
}
