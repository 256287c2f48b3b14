// cache_sim_segments_scan for Hopper (sm_90a): occupancy-masked LRU stack
// distances on a padded, self-aligned multi-tenant tape.
//
// Replaces the TPU kernel cache_sim_segments_scan in src/repro/kernels/
// cache_sim/kernel.py:136 (pl.pallas_call at :173). The tape holds one
// padded segment per seg_width-aligned block (the layout of
// core/batch_sim.padded_segment_layout), and the kernel counts
//
//     SD[i] = #{ j : prev[i] < j < i, occ[j] > 0, nxt[j] >= i,
//                j / w == i / w }                      (w = seg_width)
//
// The Pallas kernel sweeps an (n/256) x (w/256) tile grid, each i-tile
// against every j-tile of its own w-block, with an fp32 accumulator.
//
// On a hot row the block restriction is the same as raising prev[i] to at
// least i - i % w - 1, so with key[j] = occ[j] > 0 ? nxt[j] : -1 the row
// counts the keys >= i over [lo, i), lo = max(prev[i] + 1, i - i % w).
// The design is the tiled count of tiled_count.cuh with the block's keys
// held in shared memory: tiles of T = min(256, w) positions from the block
// start, and the interval cut into a head up to the first tile edge, the
// whole tiles after it and a tail in the row's own tile.
//
// Blocks up to kSmemWidth (16384) wide: a CTA takes R consecutive rows of
// one block, 1024 up to w = 4096 and 512 past it (fewer where the block is
// narrower); when w <= 256 a block is one tile and a CTA takes whole
// blocks, 2048 rows. It
//   1. reads its rows' prev once and finds the lowest lo among them;
//   2. stages the keys from that lo's tile to its last row into shared
//      memory, read from nxt and occ once as 16-byte vectors (the block's
//      earlier rows, which no interval of its rows reaches, are not read);
//   3. builds a count table of the whole tiles before its last row's tile:
//      for each tile k and each of its rows i, D[k][i] = the keys >= i over
//      the tiles from k up to the last row's tile. It histograms each
//      tile's keys by threshold (keys below the first row never count, keys
//      at or past the last row count for every row and share the last bin;
//      the lanes of a warp whose key falls in the largest key's bin add
//      once, since many keys of a segment are its end; two 16-bit bins a
//      word), sums the bins
//      from the top (a thread a run of 32 words, the table padded a word
//      every 32 so that a warp's runs fall in distinct banks, then the runs
//      of a row by a segmented warp scan) and the tiles from the end (a
//      thread a column). A row's
//      whole tiles [e, K) are then D[e][i] - D[K][i], two reads, however
//      long the interval;
//   4. counts the tails by coverage: a difference array over its rows'
//      tiles (key j covers rows j + 1 .. min(key, tile end - 1); the lanes
//      of a warp whose covers end at one row add once) and one scan; the
//      tail [B, i) of a row in tile B is P[i] - P[B];
//   5. counts each hot row: a thread a row finds everything but a partial
//      tile, which it counts from its shorter side (an interval inside its
//      own tile is also the tail less [B, lo); a head [lo, E) is also the
//      head tile's whole count less [E - T, lo)), so at most T / 2 direct
//      compares; the rows that have any are listed, and kSegLanes lanes a
//      row compare the staged keys as 16-byte vectors.
// Wider blocks (window 1 of the 256-tenant path can hold them): the global
// tiled count of tiled_count.cuh, with prev raised to the block start as it
// is read (BlockPrev), its sorted tiles and samples in the scratch. The
// branch is chosen by w alone.
//
// What bounds it on the card. The function's floor is its bytes: prev,
// nxt, occ and the output, four int32 arrays, 16 m bytes; a merge-sort-tree
// count's m * log2(w) operations do not bound it. This design reads prev
// and writes the output once, and reads each key word (nxt and occ) once a
// CTA that stages it: the CTAs of one block stage its prefix again, at most
// (S + 1) / 2 times a word with S CTAs a block (L2 hits, mostly). The rest
// runs from shared memory: at most T / 2 compares a row, a few table and
// coverage reads, and per CTA a histogram of its staged keys and table sums
// of (tiles x R) words.
//
// Contract. Cold rows (prev[i] < 0), which include the pad rows of a
// padded tape, write -1; prev may point anywhere (a hot row whose prev lies
// in an earlier block counts from its block start; prev[i] >= i counts 0).
// m must be a multiple of w and below 2^31 - 2^14 (the caller refuses
// larger tapes). For w > kSmemWidth scratch holds (m / 256) * (256 + 16) +
// m int32 words, 16-byte aligned (unused otherwise). The launch goes on the
// caller's stream and the function returns cudaGetLastError() so a refused
// launch is reported.

#include <climits>
#include <cuda_runtime.h>

#include "tiled_count.cuh"

namespace {

constexpr int kSegThreads = 512;
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kSegLanes = 2;                  // lanes a row's compares
constexpr int kSmemWidth = 16384;             // widest block held on chip
constexpr int kSmallRows = 2048;              // rows a CTA when w <= T
// rows a CTA when w > T: kNarrowRows up to kNarrowWidth, kWideRows past
// it, where the table (R / 2 words a tile) and the staged keys are larger
// (the fastest at the 256-tenant sampled tape's widths 4096, 8192 and
// 16384 among 256 to 1024 rows, PERF.md section 6)
constexpr int kNarrowWidth = 4096;
constexpr int kNarrowRows = 1024;
constexpr int kWideRows = 512;

// A launch's shape: rows a CTA R, CTAs a block S (0: whole blocks a CTA,
// which are one tile each), CTAs, and the shared-memory words of each part.
struct Plan {
  int R, S, ctas, key_words, table_words;
  size_t smem_bytes() const {
    return sizeof(int) * (static_cast<size_t>(key_words) + 5 * R + 4 +
                          table_words);
  }
};

Plan plan_for(int m, int w) {
  Plan p{};
  if (w <= kTile) {                           // a block is one tile
    p.R = (kSmallRows / w > 1 ? kSmallRows / w : 1) * w;
    p.S = 0;
    p.ctas = (m + p.R - 1) / p.R;
    p.key_words = (p.R + 3) / 4 * 4 + 4;
    p.table_words = 0;
  } else {
    // R: a power of two, no more than the block needs
    const int tiles = (w + kTile - 1) / kTile;          // tiles a block
    const int most = w <= kNarrowWidth ? kNarrowRows : kWideRows;
    p.R = kTile;
    while (p.R < most && p.R < w) p.R *= 2;
    p.S = (w + p.R - 1) / p.R;
    p.ctas = m / w * p.S;
    p.key_words = (w + 3) / 4 * 4 + 4;
    p.table_words = tiles * (p.R / 2 + p.R / 64);
  }
  return p;
}

// keys[j] >= i over staged positions [a, b), four a lane, kSegLanes lanes
// a row (keys 16-byte aligned, readable to b rounded up to 4); only the
// vectors at either end are masked
__device__ __forceinline__ int count_staged(const int* keys, int a, int b,
                                            int i, int sl) {
  int cnt = 0;
  for (int j = (a & ~3) + 4 * sl; j < b; j += 4 * kSegLanes) {
    const int4 x = *reinterpret_cast<const int4*>(keys + j);
    if (j >= a && j + 4 <= b) {
      cnt += (x.x >= i) + (x.y >= i) + (x.z >= i) + (x.w >= i);
    } else {
      cnt += (j >= a && x.x >= i) + (j + 1 >= a && j + 1 < b && x.y >= i) +
             (j + 2 >= a && j + 2 < b && x.z >= i) + (j + 3 < b && x.w >= i);
    }
  }
  return cnt;
}

// Inclusive prefix sums of a[0 .. len) in shared memory, in place, by the
// CTA; warp_sums holds kSegWarps words. Ends with a barrier.
__device__ void block_inclusive_scan(int* a, int len, int* warp_sums) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = (len + kSegThreads - 1) / kSegThreads;
  const int lo = min(len, tid * per);
  const int hi = min(len, lo + per);
  int own = 0;
  for (int k = lo; k < hi; ++k) own += a[k];
  int incl = own;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kSegWarps ? warp_sums[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += y;
    }
    if (lane < kSegWarps) warp_sums[lane] = v;
  }
  __syncthreads();
  int run = incl - own + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int k = lo; k < hi; ++k) {
    run += a[k];
    a[k] = run;
  }
  __syncthreads();
}

// kBig: blocks wider than a tile, T = kTile, a CTA's rows in one block;
// otherwise a block is one tile (T = w) and a CTA takes whole blocks.
template <bool kBig>
__global__ void __launch_bounds__(kSegThreads)
segments_smem_kernel(const int* __restrict__ prev,
                     const int* __restrict__ nxt,
                     const int* __restrict__ occ, int* __restrict__ out,
                     int m, int w, Plan plan) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int warp_sums[kSegWarps];
  __shared__ int s_lo_min, s_work, s_hot;
  const int R = plan.R;
  // The count table holds two bins (rows) a word, 16 bits each: a tile's
  // count is at most kTile and a sum over a block's tiles at most 16384,
  // so the halves never carry into each other, and a sum or difference of
  // words is the words of the sums. A row of the table is R / 2 words and
  // a pad word every 32, so that 32 threads that each take a run of 32
  // words fall in distinct banks.
  const int RP = R / 2 + R / 64;              // a table row, padded
  auto pad = [](int p) { return p + (p >> 5); };  // word p of a row
  int* keys = smem;                           // staged keys from kb
  int* lo_of = keys + plan.key_words;         // each row's lo, then count
  int* cov = lo_of + R;                       // coverage prefix, R + 1
  int* from = cov + R + 4;                    // the rows with compares to
  int* to = from + R;                         // do (work) and their ranges
  int* work = to + R;                         // [from, to), ~to if taken back
  int* table = work + R;                      // D[tile - t_lo][row]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  long long r0l;
  long long end;
  if (kBig) {
    const long long bsl = static_cast<long long>(blockIdx.x / plan.S) * w;
    r0l = bsl + static_cast<long long>(blockIdx.x % plan.S) * R;
    end = bsl + w;
  } else {
    r0l = static_cast<long long>(blockIdx.x) * R;
    end = m;
  }
  const int r0 = static_cast<int>(r0l);
  const int r1 = static_cast<int>(min(r0l + R, end));
  const int rows = r1 - r0;
  const int bs = kBig ? r0 - r0 % w : 0;      // the rows' block (kBig)
  // the start of the tile that holds position p
  auto tile_start = [bs, w](int p) {
    return kBig ? bs + ((p - bs) & ~(kTile - 1)) : p - p % w;
  };

  // 1. each row's lo (cold: -1), and the lowest over non-empty intervals
  if (tid == 0) {
    s_lo_min = INT_MAX;
    s_work = 0;
    s_hot = kNever;
  }
  __syncthreads();
  int lo_min = INT_MAX;
  for (int u = tid; u < rows; u += kSegThreads) {
    const int i = r0 + u;
    const int p = prev[i];
    int lo = -1;
    if (p >= 0) {
      lo = min(max(p + 1, kBig ? bs : i - i % w), i);
      if (lo < i) lo_min = min(lo_min, lo);
    }
    lo_of[u] = lo;
  }
  lo_min = __reduce_min_sync(0xffffffffu, lo_min);
  if (lane == 0) atomicMin(&s_lo_min, lo_min);
  __syncthreads();

  // 2. stage the keys [kb, r1); clear the coverage and the table
  int kb = r0;
  int t_lo = 0;                               // first tile of the table
  int n_rows_tab = 0;                         // its tiles, the last zero
  if (kBig) {
    const int lm = s_lo_min;
    if (lm != INT_MAX) kb = min(tile_start(lm), r0);
    t_lo = (kb - bs) / kTile;
    n_rows_tab = (r1 - 1 - bs) / kTile - t_lo + 1;
  }
  // as 16-byte vectors where the range and the arrays allow; the largest
  // key is noted (a segment's end, which many of its keys are)
  int hot = kNever;
  if (((kb | r1) & 3) == 0 &&
      ((reinterpret_cast<size_t>(nxt) | reinterpret_cast<size_t>(occ)) &
       15) == 0) {
    const int4* o4 = reinterpret_cast<const int4*>(occ + kb);
    const int4* x4 = reinterpret_cast<const int4*>(nxt + kb);
    int4* k4 = reinterpret_cast<int4*>(keys);
#pragma unroll 4
    for (int v = tid; v < (r1 - kb) / 4; v += kSegThreads) {
      const int4 o = o4[v];
      const int4 x = x4[v];
      const int4 k = make_int4(o.x > 0 ? x.x : kNever, o.y > 0 ? x.y : kNever,
                               o.z > 0 ? x.z : kNever, o.w > 0 ? x.w : kNever);
      k4[v] = k;
      hot = max(hot, max(max(k.x, k.y), max(k.z, k.w)));
    }
  } else {
#pragma unroll 4
    for (int j = kb + tid; j < r1; j += kSegThreads) {
      const int o = occ[j];
      const int x = nxt[j];
      keys[j - kb] = o > 0 ? x : kNever;
      hot = max(hot, o > 0 ? x : kNever);
    }
  }
  hot = __reduce_max_sync(0xffffffffu, hot);
  if (lane == 0) atomicMax(&s_hot, hot);
  for (int u = tid; u <= rows; u += kSegThreads) cov[u] = 0;
  for (int v = tid; v < n_rows_tab * RP; v += kSegThreads) table[v] = 0;
  __syncthreads();

  // 3. the count table of the whole tiles [t_lo, K_last)
  if (kBig && n_rows_tab > 1) {
    const int hend = bs + (t_lo + n_rows_tab - 1) * kTile;
    // a warp's 32 keys lie in one tile; its lanes whose key falls in the
    // largest key's bin (a segment's end, thousands of keys) add once
    const int hot_bin = s_hot < r0 ? -1 : min(s_hot - r0, R - 1);
    for (int j0 = kb; j0 < hend; j0 += kSegThreads) {   // warp-uniform
      const int j = j0 + tid;
      const int key = j < hend ? keys[j - kb] : kNever;
      const int bin = key < r0 ? -1 : min(key - r0, R - 1);
      int* row = table + (j - kb) / kTile * RP;
      const unsigned at_hot = __ballot_sync(0xffffffffu, bin == hot_bin &&
                                                             bin >= 0);
      if (bin >= 0 && bin != hot_bin) {
        atomicAdd(&row[pad(bin >> 1)], 1 << (16 * (bin & 1)));
      } else if (bin >= 0 && lane == __ffs(at_hot) - 1) {
        atomicAdd(&row[pad(bin >> 1)], __popc(at_hot) << (16 * (bin & 1)));
      }
    }
    __syncthreads();
    // words summed from the top: word p of tile k then holds, low and
    // high, the keys of tile k in even and in odd bins >= 2p; bin l's
    // suffix (the keys >= r0 + l) is low + high of word l / 2 for an even
    // l, high of word l / 2 + low of word l / 2 + 1 for an odd one. A
    // thread a run of 32 words, then the runs of a row (R / 64 of them,
    // lanes of one warp) by a segmented suffix scan
    const int runs = R / 64;
    const int n_runs = (n_rows_tab - 1) * runs;
    for (int t0 = 0; t0 < n_runs; t0 += kSegThreads) {  // warp-uniform
      const int t = t0 + tid;
      int* run = table + t * 33;              // row t / runs, run t % runs
      int sum = 0;
      if (t < n_runs) {
#pragma unroll 8
        for (int q = 31; q >= 0; --q) {
          sum += run[q];
          run[q] = sum;
        }
      }
      int after = sum;
      for (int off = 1; off < runs; off <<= 1) {
        const int y = __shfl_down_sync(0xffffffffu, after, off, runs);
        if (lane % runs + off < runs) after += y;
      }
      after -= sum;
      if (t < n_runs && after != 0) {
#pragma unroll 8
        for (int q = 0; q < 32; ++q) run[q] += after;
      }
    }
    __syncthreads();
    // tiles summed from the end: D[k][l] over tiles k .. K_last - 1
    for (int l = tid; l < R / 2; l += kSegThreads) {
      int* col = table + pad(l);
      int acc = 0;
      for (int row = n_rows_tab - 2; row >= 0; --row) {
        acc += col[row * RP];
        col[row * RP] = acc;
      }
    }
  }

  // 4. coverage of the rows' own tiles: cov[u] - cov[B - r0] is the tail
  for (int p0 = r0; p0 < r1; p0 += kSegThreads) {      // warp-uniform
    const int p = p0 + tid;
    int stop = -1;                            // where a cover ends, if inside
    if (p < r1) {
      const int key = keys[p - kb];
      const int ts = tile_start(p);
      const int te = kBig ? min(ts + kTile, bs + w) : ts + w;
      const int last = min(key, te - 1);
      if (last > p) {
        atomicAdd(&cov[p + 1 - r0], 1);
        if (last + 1 < te) stop = last + 1 - r0;
      }
    }
    const unsigned peers = __match_any_sync(0xffffffffu, stop);
    if (stop >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&cov[stop], -__popc(peers));
  }
  __syncthreads();
  block_inclusive_scan(cov, rows, warp_sums);

  // 5. the rows. A partial tile is counted from its shorter side:
  // [lo, i) inside the row's tile is also the tail count less [B, lo); a
  // head [lo, E) is also tile E - T's whole count less [E - T, lo); so a
  // row compares at most T / 2 keys. A thread a row finds its count but
  // for those compares, then kSegLanes lanes a row do the compares.
  for (int u0 = 0; u0 < rows; u0 += kSegThreads) {     // warp-uniform
    const int u = u0 + tid;
    bool direct = false;
    int a = 0, b = 0;                         // the direct part
    if (u < rows) {
      const int i = r0 + u;
      const int lo = lo_of[u];
      int c = -1;                             // cold
      int sign = 1;
      if (lo >= 0) {
        c = 0;
        if (lo < i) {
          const int B = tile_start(i);
          const int tail = cov[u] - cov[B - r0];
          if (lo > B) {                       // inside the row's tile
            if (i - lo <= lo - B) {
              a = lo, b = i;
            } else {
              a = B, b = lo, sign = -1, c = tail;
            }
          } else {
            c = tail;
            if (kBig && lo < B) {             // head, whole tiles
              const int hs = tile_start(lo);
              int from_tile = hs;             // whole tiles from here
              if (lo == hs) {
              } else if (hs + kTile - lo <= lo - hs) {
                a = lo, b = hs + kTile, from_tile = b;
              } else {
                a = hs, b = lo, sign = -1;
              }
              // the whole tiles [from_tile, B): D[from_tile] - D[B]
              const int* d0 =
                  table + ((from_tile - bs) / kTile - t_lo) * RP;
              const int* d1 = table + ((B - bs) / kTile - t_lo) * RP;
              const int p = u >> 1;
              const int lo_w = d0[pad(p)] - d1[pad(p)];
              if (u & 1) {
                const int hi_w = p + 1 < R / 2
                                     ? d0[pad(p + 1)] - d1[pad(p + 1)]
                                     : 0;
                c += (lo_w >> 16) + (hi_w & 0xffff);
              } else {
                c += (lo_w >> 16) + (lo_w & 0xffff);
              }
            }
          }
        }
      }
      lo_of[u] = c;
      direct = a < b;
      a -= kb;
      b = sign > 0 ? b - kb : ~(b - kb);
    }
    const unsigned has = __ballot_sync(0xffffffffu, direct);
    int at = 0;
    if (lane == 0 && has) at = atomicAdd(&s_work, __popc(has));
    at = __shfl_sync(0xffffffffu, at, 0) + __popc(has & ((1u << lane) - 1));
    if (direct) {
      work[at] = u;
      from[at] = a;
      to[at] = b;
    }
  }
  __syncthreads();
  const int n_work = s_work;
  const int sub = lane / kSegLanes;
  const int sl = lane % kSegLanes;
  constexpr int kRowsAtOnce = kSegThreads / kSegLanes;
  for (int q0 = warp * (32 / kSegLanes); q0 < n_work; q0 += kRowsAtOnce) {
    const int q = q0 + sub;                   // warp-uniform loop
    int c = 0;
    int u = 0;
    int sign = 1;
    if (q < n_work) {
      u = work[q];
      int b = to[q];
      if (b < 0) b = ~b, sign = -1;
      c = count_staged(keys, from[q], b, r0 + u, sl);
    }
    for (int off = kSegLanes / 2; off > 0; off >>= 1)
      c += __shfl_xor_sync(0xffffffffu, c, off);
    if (sl == 0 && q < n_work) lo_of[u] += sign * c;
  }
  __syncthreads();
  for (int u = tid; u < rows; u += kSegThreads) out[r0 + u] = lo_of[u];
}

// A hot row's prev raised to its block start, for the global tiled count.
struct BlockPrev {
  int w;
  __device__ __forceinline__ int operator()(const int* __restrict__ prev,
                                            long long j) const {
    const int p = prev[j];
    return p < 0 ? p : max(p, static_cast<int>(j - j % w) - 1);
  }
};

}  // namespace

extern "C" int cache_sim_segments_scan(const void* prev, const void* nxt,
                                       const void* occ, void* out,
                                       void* scratch, int m, int w,
                                       void* stream) {
  if (m <= 0) return 0;
  if (w <= 0 || m % w != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(prev);
  const int* x = static_cast<const int*>(nxt);
  const int* o = static_cast<const int*>(occ);
  int* counts = static_cast<int*>(out);
  if (w > kSmemWidth) {
    return launch_tiled_count<true>(p, x, o, WriteCount{counts},
                                    static_cast<int*>(scratch), m, s,
                                    BlockPrev{w});
  }
  const Plan plan = plan_for(m, w);
  const int bytes = static_cast<int>(plan.smem_bytes());
  auto* kernel = plan.S > 0 ? segments_smem_kernel<true>
                            : segments_smem_kernel<false>;
  // the shared memory a launch may ask for, raised only when a width needs
  // more than any before it in this process (the call costs host time at
  // every launch otherwise; a launch past the limit is refused, and the
  // error returned)
  static int allowed[2] = {0, 0};
  int& most = allowed[plan.S > 0];
  if (bytes > most) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    most = bytes;
  }
  kernel<<<plan.ctas, kSegThreads, bytes, s>>>(p, x, o, counts, m, w, plan);
  return static_cast<int>(cudaGetLastError());
}
