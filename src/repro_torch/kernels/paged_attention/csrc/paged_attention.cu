// paged_attention for Hopper (sm_90a): GQA decode attention over a paged
// KV pool, one query token per sequence, fp32 online softmax.
//
// Replaces the TPU kernel paged_attention in
// src/repro/kernels/paged_attention/kernel.py:76 (pl.pallas_call at :117).
// That kernel walks a (batch, kv head, page) grid with the page axis
// sequential, takes the block table and the lengths by scalar prefetch so
// that the page id feeds the BlockSpec's DMA, and keeps the fp32 running
// max, sum and accumulator of the head's query group in VMEM scratch. Here
// the page axis is cut into splits that run in parallel, each CTA reads
// its own row's length and table (there is no scalar prefetch), and the
// splits' states are merged afterwards by the log-sum-exp combination.
//
// Semantics, as the reference: q [B, Hq, D]; k_pages, v_pages
// [n_pool, page, Hkv, D] (one layer of the pool); block_tables [B, pps]
// int32; seq_lens [B] int32. Position s of row b lives at offset s % page
// of pool page block_tables[b][s / page]. Query heads h*g .. h*g+g-1
// (g = Hq / Hkv) read KV head h. Scores are (q . k) * scale in fp32;
// positions at or past min(seq_len, pps * page) are never read; the output
// is acc / max(l, 1e-30) in q's dtype. A row of length 0 reads nothing and
// writes 0, as the Pallas kernel does. Optionally, k_self and v_self
// [B, Hkv, D] (null for none) are one more position of each row, past its
// pooled ones: the serving decode's in-flight token, whose K/V enters the
// pool only after the step. Its score (q . k_self) * scale is formed in
// fp32 and it enters the merge as one more partial (m = s_self, l = 1,
// acc = v_self) after the splits, so a row of length 0 then gives v_self
// exactly. A table entry outside [0, n_pool) is
// clamped into it, as JAX's gather clamps, so no read leaves the pool (the
// wrapper cannot check the entries without a host sync). f32 and bf16; D a
// multiple of 4 up to 128; g up to 16.
//
// Design: split-KV over a cp.async page ring.
// - Grid (KV head, row, split). Split z takes pages [z * pages_per_split,
//   (z + 1) * pages_per_split) of the row's table; the wrapper picks the
//   split count from the table's width and the SM count (it cannot read
//   the lengths without a host sync), so that small batches still fill the
//   card. A split that starts at or past the row's length reads nothing
//   and writes an empty partial (m = -1e30, l = 0, acc = 0).
// - A CTA of 128 threads streams its positions in tiles (64 positions in
//   bf16, 32 in f32) through a 3-stage ring in shared memory: 16-byte
//   cp.async copies (8-byte where a row is not a multiple of 16 bytes),
//   neighbouring threads on neighbouring chunks of a K or V row (16
//   threads a 256-byte bf16 row), so a warp's copy is two whole rows; the
//   loads of the next two tiles are in flight while one is computed. The
//   split's table entries are staged in shared memory first, and each
//   tile's pool positions are looked up one tile ahead of its copies into
//   a small ring of their own. Rows are padded by 16 bytes, so the score
//   phase's row reads are free of bank conflicts.
// - Scores: one thread owns a (position, head) pair and forms its dot from
//   the shared K row and q, held in shared memory in fp32 (a warp reads
//   one head's q: a broadcast). No warp reduction per position.
// - Softmax: one warp a head takes the tile's max and sum (two warp
//   reductions a head a tile, not a position).
// - P.V: a thread owns four output columns of every head for one slice of
//   the tile's positions, reading p from shared memory; the slices are
//   summed once, through shared memory, at the end.
// - Merge: with one split the CTA writes the output itself. Otherwise each
//   CTA writes an fp32 partial (m, l, acc) per query head to a workspace
//   and a second small kernel combines the splits in order, so the result
//   is the same from call to call. The in-flight position is the last
//   partial the merge kernel takes (with one split, the split's CTA folds
//   it into its own output), so the order stays fixed. (Merging in the
//   last CTA of each (row,
//   KV head), found by an atomic ticket, gave the same bits and measured
//   slower; PERF.md section 6.) An empty split's exp(-1e30 - m) is 0, and a
//   row whose splits are all empty comes out as 0 / 1e-30 = 0: no -inf, no
//   NaN.
//
// What bounds it on this card. The function reads each visible K and V
// row once, seq_len * Hkv * D * 2 values a batch row, plus q, the tables
// and the output, and does 4 * Hq * D FLOPs a position: at qwen3-0.6b's
// decode (B 32, lengths near 2046, Hkv 8, D 128, bf16) that is 268.5 MB
// against 0.54 GFLOP, 0.080 ms at 3.35 TB/s, so the bytes bound it. The
// ring keeps two tiles (64 KB in bf16) in flight per CTA and two CTAs fit
// an SM; the partials add B * Hq * splits * (D + 2) * 4 bytes each way
// (under 1 MB at that shape), the in-flight K/V 2 * B * Hkv * D values.
// What is left above the bound is the per-tile barriers and the score and
// P.V phases, which do not overlap the copies of the same CTA (PERF.md
// section 6 has the times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
constexpr int kPad = 16;                      // bytes after each ring row
constexpr int kMaxD = 128;
constexpr int kMaxGroup = 16;
constexpr int kMaxSplitPages = 1024;          // table entries a CTA stages
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;               // cards with their own limit

template <typename T>
struct TileOf;
template <>
struct TileOf<float> {
  static constexpr int value = 32;
};
template <>
struct TileOf<__nv_bfloat16> {
  static constexpr int value = 64;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ __forceinline__ int ring_row_bytes(int D, int esize) {
  return D * esize + kPad;
}

// Shared memory of one CTA: the ring, reused at the end for the slices'
// sums (body_bytes), then q in fp32, the scores, (m, l, alpha) per head and
// the split's table entries.
template <typename T>
__host__ __device__ __forceinline__ int body_bytes(int D, int g) {
  const int ring = kStages * 2 * TileOf<T>::value *
                   ring_row_bytes(D, sizeof(T));
  const int reduce = kThreads / (D / 4) * g * D * 4;
  return ring > reduce ? ring : reduce;
}

template <typename T>
__host__ __device__ __forceinline__ int smem_bytes(int D, int g,
                                                   int pages_per_split) {
  constexpr int tile = TileOf<T>::value;
  return body_bytes<T>(D, g) +
         4 * (g * D + g * tile + 3 * g + pages_per_split + kStages * tile);
}

// q . k over D columns: q in fp32 (shared, a broadcast), k a ring row;
// bf16 rows are read 16 bytes at a time where D allows
__device__ __forceinline__ float dot_row(const float* k, const float* q,
                                         int D) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int c = 0; c < D; c += 4) {
    const float4 kk = load4(k + c);
    const float4 qq = load4(q + c);
    a0 += qq.x * kk.x;
    a1 += qq.y * kk.y;
    a2 += qq.z * kk.z;
    a3 += qq.w * kk.w;
  }
  return (a0 + a1) + (a2 + a3);
}

__device__ __forceinline__ float dot_row(const __nv_bfloat16* k,
                                         const float* q, int D) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (D % 8 == 0) {
    for (int c = 0; c < D; c += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(k + c);
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 x0 = __bfloat1622float2(k2[0]);
      const float2 x1 = __bfloat1622float2(k2[1]);
      const float2 x2 = __bfloat1622float2(k2[2]);
      const float2 x3 = __bfloat1622float2(k2[3]);
      const float4 q0 = load4(q + c);
      const float4 q1 = load4(q + c + 4);
      a0 += q0.x * x0.x + q1.x * x2.x;
      a1 += q0.y * x0.y + q1.y * x2.y;
      a2 += q0.z * x1.x + q1.z * x3.x;
      a3 += q0.w * x1.y + q1.w * x3.y;
    }
  } else {
    for (int c = 0; c < D; c += 4) {
      const float4 kk = load4(k + c);
      const float4 qq = load4(q + c);
      a0 += qq.x * kk.x;
      a1 += qq.y * kk.y;
      a2 += qq.z * kk.z;
      a3 += qq.w * kk.w;
    }
  }
  return (a0 + a1) + (a2 + a3);
}

// One lane's share of q . k_self: four columns, in a fixed order.
__device__ __forceinline__ float dot4(float4 q, float4 k) {
  return (q.x * k.x + q.y * k.y) + (q.z * k.z + q.w * k.w);
}

// The log-sum-exp merge of one query head's n_split partials, four output
// columns c .. c + 3 (splits in order, so the sums' order is fixed), and
// with fold the in-flight position's partial (s_self, 1, v_self) last.
template <typename T>
__device__ __forceinline__ void merge_head(const float* ws_acc,
                                           const float* ws_ml, T* out,
                                           int row, int D, int n_split,
                                           int c, bool fold, float s_self,
                                           float4 v_self) {
  const float* ml = ws_ml + static_cast<long long>(row) * n_split * 2;
  float top = kNegInf;
  for (int z = 0; z < n_split; ++z) top = fmaxf(top, __ldcg(ml + 2 * z));
  if (fold) top = fmaxf(top, s_self);
  float lsum = 0.f;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* acc = ws_acc + static_cast<long long>(row) * n_split * D + c;
  for (int z = 0; z < n_split; ++z) {
    const float w = expf(__ldcg(ml + 2 * z) - top);
    lsum += __ldcg(ml + 2 * z + 1) * w;
    const float4 x = __ldcg(reinterpret_cast<const float4*>(acc + z * D));
    o.x += w * x.x;
    o.y += w * x.y;
    o.z += w * x.z;
    o.w += w * x.w;
  }
  if (fold) {
    const float w = expf(s_self - top);
    lsum += w;
    o.x += w * v_self.x;
    o.y += w * v_self.y;
    o.z += w * v_self.z;
    o.w += w * v_self.w;
  }
  const float denom = fmaxf(lsum, 1e-30f);
  store4(out + static_cast<long long>(row) * D + c,
         make_float4(o.x / denom, o.y / denom, o.z / denom, o.w / denom));
}

// G: a power of two at least the group size g (the register arrays'
// extent); heads r >= g are skipped.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ tables,
                   const int* __restrict__ lens,
                   const T* __restrict__ k_self,
                   const T* __restrict__ v_self, T* __restrict__ out,
                   float* __restrict__ ws, int n_pool, int B, int Hq,
                   int Hkv, int D, int page, int pps, int pages_per_split,
                   int n_split, float scale) {
  constexpr int tile = TileOf<T>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = Hq / Hkv;
  const int rowb = ring_row_bytes(D, sizeof(T));
  const int stage_bytes = 2 * tile * rowb;
  const int slices = kThreads / (D / 4);

  unsigned char* ring = smem;
  float* qs = reinterpret_cast<float*>(smem + body_bytes<T>(D, g));
  float* sc = qs + g * D;                     // [g][tile]: scores, then p
  float* ms = sc + g * tile;                  // running max per head
  float* ls = ms + g;                         // running sum per head
  float* al = ls + g;                         // this tile's rescale
  int* tabs = reinterpret_cast<int*>(al + g);  // the split's table
  int* rowtab = tabs + pages_per_split;        // [kStages][tile] positions

  const int len = max(0, min(lens[b], pps * page));
  const int first_page = split * pages_per_split;
  const int p0 = first_page * page;
  const int npages = max(0, min(pages_per_split, pps - first_page));
  const int p1 = min(len, p0 + npages * page);   // this split reads [p0, p1)
  const int ntiles = p1 > p0 ? (p1 - p0 + tile - 1) / tile : 0;

  const int* tab = tables + static_cast<long long>(b) * pps + first_page;
  const int used = p1 > p0 ? (p1 - p0 + page - 1) / page : 0;
  for (int k = tid; k < used; k += kThreads)
    tabs[k] = min(max(tab[k], 0), n_pool - 1);
  const T* qg = q + (static_cast<long long>(b) * Hq + h * g) * D;
  for (int k = tid * 4; k < g * D; k += kThreads * 4)
    store4(qs + k, load4(qg + k));
  if (tid < g) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  __syncthreads();

  // the pool position (page id * page + offset) of each row of tile t,
  // into its slot of rowtab; one thread a row
  auto locate = [&](int t) {
    const int rel = t * tile + tid;
    if (tid < tile && p0 + rel < p1)
      rowtab[(t % kStages) * tile + tid] = tabs[rel / page] * page + rel % page;
  };
  // the copies of tile t: neighbouring threads take neighbouring chunks of
  // a row (16 threads a 256-byte row), rows < tile in K, the rest in V
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const int chunk = row_bytes % 16 == 0 ? 16 : 8;
  const int per_row = row_bytes / chunk;       // at most 32
  const int row_step = kThreads / per_row;
  const int my_chunk = tid % per_row * chunk;
  const int my_row = tid / per_row;
  auto issue = [&](int t) {
    const int n = min(tile, p1 - (p0 + t * tile));
    const int* rt = rowtab + (t % kStages) * tile;
    unsigned char* stage = ring + (t % kStages) * stage_bytes + my_chunk;
    if (my_row >= row_step) return;
    for (int rc = my_row; rc < 2 * tile; rc += row_step) {
      const int r = rc < tile ? rc : rc - tile;
      if (r >= n) continue;
      const long long prow = static_cast<long long>(rt[r]) * Hkv + h;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          (rc < tile ? kp : vp) + prow * D) + my_chunk;
      if (chunk == 16)
        cp_async16(stage + rc * rowb, src);
      else
        cp_async8(stage + rc * rowb, src);
    }
  };

  const int grp = tid % (D / 4);              // this thread's four columns
  const int slice = tid / (D / 4);            // and slice of positions
  const bool pv = slice < slices;
  float acc[G][4];
#pragma unroll
  for (int r = 0; r < G; ++r)
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

  for (int k = 0; k < kStages && k < ntiles; ++k) locate(k);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < ntiles) issue(k);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    // tile t has landed for every thread, and every thread is done with
    // tile t - 1, whose slot the next issue refills
    __syncthreads();
    if (t + kStages - 1 < ntiles) issue(t + kStages - 1);
    cp_async_commit();
    // tile t's rowtab slot is free again (its copies are issued): locate
    // tile t + kStages there, published by the barrier below
    if (t + kStages < ntiles) locate(t + kStages);
    const int n = min(tile, p1 - (p0 + t * tile));
    const unsigned char* kt = ring + (t % kStages) * stage_bytes;
    const unsigned char* vt = kt + tile * rowb;

    for (int pr = tid; pr < g * tile; pr += kThreads) {
      const int r = pr % tile;
      const int hh = pr / tile;
      float s = kNegInf;
      if (r < n)
        s = dot_row(reinterpret_cast<const T*>(kt + r * rowb), qs + hh * D,
                    D) * scale;
      sc[hh * tile + r] = s;
    }
    __syncthreads();

    for (int hh = warp; hh < g; hh += kWarps) {
      float* srow = sc + hh * tile;
      float mx = kNegInf;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, srow[r]);
      mx = warp_max(mx);
      const float m_old = ms[hh];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < tile; r += 32) {
        const float p = r < n ? expf(srow[r] - m_new) : 0.f;
        srow[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        al[hh] = a;
        ls[hh] = ls[hh] * a + sum;
        ms[hh] = m_new;
      }
    }
    __syncthreads();

    if (pv) {
#pragma unroll
      for (int r = 0; r < G; ++r) {
        if (r < g) {
          const float a = al[r];
          acc[r][0] *= a;
          acc[r][1] *= a;
          acc[r][2] *= a;
          acc[r][3] *= a;
        }
      }
      for (int r = slice; r < n; r += slices) {
        const float4 vv =
            load4(reinterpret_cast<const T*>(vt + r * rowb) + grp * 4);
#pragma unroll
        for (int hh = 0; hh < G; ++hh) {
          if (hh < g) {
            const float p = sc[hh * tile + r];
            acc[hh][0] += p * vv.x;
            acc[hh][1] += p * vv.y;
            acc[hh][2] += p * vv.z;
            acc[hh][3] += p * vv.w;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // with one split this CTA folds the in-flight position in itself: its
  // score per head into al (free now), one warp a head, lanes over columns
  const bool fold = k_self != nullptr && n_split == 1;
  const long long kv_row = (static_cast<long long>(b) * Hkv + h) * D;
  if (fold) {
    for (int hh = warp; hh < g; hh += kWarps) {
      const int c = lane * 4;
      const float part =
          c < D ? dot4(load4(qs + hh * D + c), load4(k_self + kv_row + c))
                : 0.f;
      const float s = warp_sum(part);
      if (lane == 0) al[hh] = s * scale;
    }
  }

  // sum the slices: red [slices][g][D] over the ring
  float* red = reinterpret_cast<float*>(smem);
  if (pv) {
#pragma unroll
    for (int r = 0; r < G; ++r)
      if (r < g)
        store4(red + (slice * g + r) * D + grp * 4,
               make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
  }
  __syncthreads();
  const long long bh = static_cast<long long>(b) * Hq + h * g;
  float* ws_acc = ws;
  float* ws_ml = ws + static_cast<long long>(B) * Hq * n_split * D;
  for (int o = tid; o < g * (D / 4); o += kThreads) {
    const int r = o / (D / 4);
    const int c = (o % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sl = 0; sl < slices; ++sl) {
      const float4 y = load4(red + (sl * g + r) * D + c);
      x.x += y.x;
      x.y += y.y;
      x.z += y.z;
      x.w += y.w;
    }
    if (fold) {
      // the merge's two partials: the pool's (ms, ls, x), then the
      // in-flight position's (s_self, 1, v_self)
      const float s_self = al[r];
      const float top = fmaxf(ms[r], s_self);
      const float wp = expf(ms[r] - top);
      const float w = expf(s_self - top);
      const float denom = fmaxf(ls[r] * wp + w, 1e-30f);
      const float4 v = load4(v_self + kv_row + c);
      store4(out + (bh + r) * D + c,
             make_float4((x.x * wp + w * v.x) / denom,
                         (x.y * wp + w * v.y) / denom,
                         (x.z * wp + w * v.z) / denom,
                         (x.w * wp + w * v.w) / denom));
    } else if (n_split == 1) {
      const float denom = fmaxf(ls[r], 1e-30f);
      store4(out + (bh + r) * D + c, make_float4(x.x / denom, x.y / denom,
                                                 x.z / denom, x.w / denom));
    } else {
      const long long part = (bh + r) * n_split + split;
      store4(ws_acc + part * D + c, x);
      if (c == 0) {
        ws_ml[2 * part] = ms[r];
        ws_ml[2 * part + 1] = ls[r];
      }
    }
  }
}

// one warp a (row, query head), lanes over columns; with k_self the warp
// first forms the in-flight position's score (query head hq reads KV head
// hq / g) and each lane reads its four columns of v_self
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const float* __restrict__ ws, const T* __restrict__ q,
                   const T* __restrict__ k_self,
                   const T* __restrict__ v_self, T* __restrict__ out, int B,
                   int Hq, int Hkv, int D, int n_split, float scale) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int c = (threadIdx.x & 31) * 4;
  // a whole warp leaves here or none: the score below is a warp's sum
  if (row >= B * Hq) return;
  const bool fold = k_self != nullptr;
  float s_self = 0.f;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (fold) {
    const long long kv_row =
        (static_cast<long long>(row / Hq) * Hkv + row % Hq / (Hq / Hkv)) * D;
    float part = 0.f;
    if (c < D) {
      part = dot4(load4(q + static_cast<long long>(row) * D + c),
                  load4(k_self + kv_row + c));
      v = load4(v_self + kv_row + c);
    }
    s_self = warp_sum(part) * scale;
  }
  if (c >= D) return;
  merge_head(ws, ws + static_cast<long long>(B) * Hq * n_split * D, out, row,
             D, n_split, c, fold, s_self, v);
}

template <typename T, int G>
int launch_group(const void* q, const void* kp, const void* vp,
                 const int* tables, const int* lens, const void* ks,
                 const void* vs, void* out, void* ws,
                 int B, int n_pool, int Hq, int Hkv, int D, int page,
                 int pps, int pages_per_split, int n_split,
                 float scale, cudaStream_t stream) {
  const int g = Hq / Hkv;
  const int smem = smem_bytes<T>(D, g, pages_per_split);
  // raise the kernel's shared-memory limit on the current card only when a
  // launch there needs more than it was given before (so a CUDA graph
  // captured after a warm-up call makes no such call)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int granted[kMaxDevices] = {};
  if (smem > 48 * 1024 && (dev >= kMaxDevices || smem > granted[dev])) {
    err = cudaFuncSetAttribute(paged_split_kernel<T, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) granted[dev] = smem;
  }
  const dim3 grid(Hkv, B, n_split);
  paged_split_kernel<T, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, lens, static_cast<const T*>(ks),
      static_cast<const T*>(vs), static_cast<T*>(out),
      static_cast<float*>(ws), n_pool, B, Hq, Hkv, D, page, pps,
      pages_per_split, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  const int rows = B * Hq;
  paged_merge_kernel<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0,
                          stream>>>(
      static_cast<const float*>(ws), static_cast<const T*>(q),
      static_cast<const T*>(ks), static_cast<const T*>(vs),
      static_cast<T*>(out), B, Hq, Hkv, D, n_split, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* lens, const void* ks, const void* vs, void* out,
           void* ws, int B, int n_pool, int Hq,
           int Hkv, int D, int page, int pps,
           int pages_per_split, int n_split, float scale,
           cudaStream_t stream) {
  const int g = Hq / Hkv;
#define PAGED_LAUNCH(G)                                                     \
  return launch_group<T, G>(q, kp, vp, tables, lens, ks, vs, out, ws, B,   \
                            n_pool,                                         \
                            Hq, Hkv, D, page, pps, pages_per_split,         \
                            n_split, scale, stream)
  if (g <= 1) PAGED_LAUNCH(1);
  if (g <= 2) PAGED_LAUNCH(2);
  if (g <= 4) PAGED_LAUNCH(4);
  if (g <= 8) PAGED_LAUNCH(8);
  PAGED_LAUNCH(kMaxGroup);
#undef PAGED_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ws: B * Hq * n_split * (D + 2) floats
// (unused when n_split is 1). k_self, v_self: [B, Hkv, D] in q's dtype, or
// both null. Returns a cudaError_t (0 on success); the
// caller also checks shapes, contiguity and 16-byte alignment. The kernel
// reads a row's first
// ceil(min(seq_len, pps * page) / page) table entries and those pages, no
// other.
extern "C" int paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const void* tables,
                               const void* lens, const void* k_self,
                               const void* v_self, void* out, void* ws, int B,
                               int n_pool, int Hq, int Hkv, int D, int page,
                               int pps, int pages_per_split, int n_split,
                               float scale, int dtype, void* stream) {
  if (B <= 0 || Hq <= 0) return 0;
  if (D <= 0 || D % 4 != 0 || D > kMaxD || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > kMaxGroup || page <= 0 || pps < 0 || n_pool <= 0 ||
      static_cast<long long>(n_pool) * page >= (1LL << 31) ||
      n_split <= 0 || pages_per_split <= 0 ||
      (k_self == nullptr) != (v_self == nullptr) ||
      pages_per_split > kMaxSplitPages ||
      static_cast<long long>(pages_per_split) * n_split <
          static_cast<long long>(pps))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* n = static_cast<const int*>(lens);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, t, n, k_self, v_self, out, ws,
                         B, n_pool,
                         Hq, Hkv, D, page, pps, pages_per_split, n_split,
                         scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, t, n, k_self, v_self,
                                 out, ws, B,
                                 n_pool, Hq, Hkv, D, page, pps,
                                 pages_per_split, n_split, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
