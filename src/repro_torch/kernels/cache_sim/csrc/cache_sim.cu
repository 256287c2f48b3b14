// cache_sim_scan for Hopper (sm_90a): occupancy-masked LRU stack distances.
//
// Replaces the TPU kernel cache_sim_scan in src/repro/kernels/cache_sim/
// kernel.py:63 (pl.pallas_call at :84), which counts
//
//     SD[i] = #{ j : prev[i] < j < i,  occ[j] > 0,  nxt[j] >= i }
//
// over the whole (i, j) plane in 256 x 256 tiles with an fp32 accumulator.
//
// Design: a tiled count on sorted tiles, two kernels in one call, so the
// work no longer grows with the reuse intervals' lengths.
// - Pass 1 (sort_tiles_kernel): the tape is cut into tiles of T = 256
//   positions (kTile; 128 measured the same and 512 slower, PERF.md
//   section 6). One CTA a tile loads
//   key[j] = occ[j] > 0 ? nxt[j] : -1 (-1 never counts: a hot row has
//   i >= 1), writes the keys, and, for a whole tile, sorts them in shared
//   memory with a bitonic sort and writes the sorted tile plus every 16th
//   sorted key (the largest of each block of 16, "samples") to scratch.
// - Pass 2 (tiled_count_kernel): one CTA the T rows of one tile. The
//   interval (prev[i], i) of a row splits into a head up to the first tile
//   edge, the whole tiles strictly inside, and a tail from the row's own
//   tile start to i. The tails of all T rows come at once from an in-tile
//   coverage count (a difference array over the tile's keys and one scan);
//   a row whose interval lies inside its tile and a head (under T
//   positions) are counted by direct compares of the keys, 16-byte vectors
//   over 16 lanes a row; a whole tile is one search for i in its sorted
//   keys, the count of entries >= i: its T / 16 samples say which block of
//   16 holds the first key >= i and that block's 16 keys say where in it,
//   two rounds of 16-byte loads; the lanes of a row take different tiles.
//   All rows of a tile run on one SM, so the sorted tiles just before it,
//   which most of its rows search, are read from L1.
// The work per row is at most T - 1 compares plus one search a whole tile:
// on a 16-tenant MSR window at T = 256 about a tenth of the previous
// design's sum of interval lengths. Counts are exact int32 at any length
// (the TPU's fp32 accumulator is exact only below 2^24).
//
// Pass 1, count_ge, count_direct and the coverage of pass 2 are written to
// be shared with the other interval walks of the port (urd_scan,
// cache_sim_levels_scan), which count over the same intervals.
//
// What bounds it on the card. The function's floor is its bytes: reading
// prev, nxt and occ once and writing SD once is 16 n bytes; a Fenwick-tree
// count needs only n * ceil(log2 n) operations, which do not bound it. The
// two passes move about 16 n + 8 n scratch bytes (keys and sorted tiles
// written, then read) plus the head and tail compares and the searches,
// most of them L1 and L2 hits: the compares, not the floor, still set the
// time.
//
// Contract. Cold rows (prev[i] < 0) write -1 (a prefix count there would
// cost O(i) and no caller uses it). The grids mask their own ragged edge,
// so any n works without padding, n < T included (no tile is whole then);
// the caller keeps n < 2^31 - 32. The launches go on the caller's stream
// and the function returns cudaGetLastError() so a refused launch is
// reported. Scratch: n_tiles * (T + T / 16) + n ints, n_tiles = n / T.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;                    // T: positions a tile
constexpr int kThreads = 256;                 // pass 2's CTA
constexpr int kLanes = 16;                    // lanes a row, direct parts
constexpr int kBlock = 16;                    // sorted keys per sample
constexpr int kNever = -1;                    // the key of a non-occupant

// Pass 1: keys of every position; the sorted keys and samples of every
// whole tile.
__global__ void __launch_bounds__(kTile)
sort_tiles_kernel(const int* __restrict__ nxt, const int* __restrict__ occ,
                  int* __restrict__ keys, int* __restrict__ sorted,
                  int* __restrict__ samples, int n) {
  __shared__ int s[kTile];
  const int t = threadIdx.x;
  const long long j = static_cast<long long>(blockIdx.x) * kTile + t;
  int key = kNever;
  if (j < n) {
    key = occ[j] > 0 ? nxt[j] : kNever;
    keys[j] = key;
  }
  // CTA-uniform: a ragged last tile is not sorted
  if (static_cast<long long>(blockIdx.x + 1) * kTile > n) return;
  s[t] = key;
  __syncthreads();
  for (int k = 2; k <= kTile; k <<= 1) {
    for (int w = k >> 1; w > 0; w >>= 1) {
      const int u = t ^ w;
      if (u > t) {
        const int a = s[t];
        const int b = s[u];
        if ((a > b) == ((t & k) == 0)) {
          s[t] = b;
          s[u] = a;
        }
      }
      __syncthreads();
    }
  }
  sorted[j] = s[t];
  if (t % kBlock == kBlock - 1)
    samples[static_cast<long long>(blockIdx.x) * (kTile / kBlock) +
            t / kBlock] = s[t];
}

// Exclusive prefix sums of a[0 .. len) in shared memory, in place, by a
// CTA of kThreads threads (len <= 4 * kThreads); returns the total.
__device__ __forceinline__ int block_scan(int* a, int len, int* warp_sums) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = (len + kThreads - 1) / kThreads;
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
    int w = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kThreads / 32) warp_sums[lane] = w;   // inclusive
  }
  __syncthreads();
  int run = incl - own + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int k = lo; k < hi; ++k) {
    const int x = a[k];
    a[k] = run;
    run += x;
  }
  const int total = warp_sums[kThreads / 32 - 1];
  __syncthreads();
  return total;
}

// Entries >= i among tile k's sorted keys: the tile's T / 16 samples say
// how many blocks of 16 lie wholly below i, then the block of 16 keys they
// point to says where in it; both read as 16-byte vectors.
__device__ __forceinline__ int count_ge(const int* __restrict__ sorted,
                                        const int* __restrict__ samples,
                                        long long k, int i) {
  constexpr int kSamples = kTile / kBlock;
  const int4* sm = reinterpret_cast<const int4*>(samples + k * kSamples);
  int below = 0;                              // blocks whose largest is < i
#pragma unroll
  for (int v = 0; v < kSamples / 4; ++v) {
    const int4 x = __ldg(sm + v);
    below += (x.x < i) + (x.y < i) + (x.z < i) + (x.w < i);
  }
  if (below == kSamples) return 0;
  const int4* blk =
      reinterpret_cast<const int4*>(sorted + k * kTile + below * kBlock);
  int in_block = 0;                           // keys < i in that block
#pragma unroll
  for (int v = 0; v < kBlock / 4; ++v) {
    const int4 x = __ldg(blk + v);
    in_block += (x.x < i) + (x.y < i) + (x.z < i) + (x.w < i);
  }
  return kTile - below * kBlock - in_block;
}

// keys[j] >= i over j in [a, b), four keys a lane, kLanes lanes a row
// (src 16-byte aligned at multiples of 4)
__device__ __forceinline__ int count_direct(const int* src, long long a,
                                            long long b, int i, int sl) {
  int cnt = 0;
#pragma unroll 4
  for (long long j = (a & ~3LL) + 4 * sl; j < b; j += 4 * kLanes) {
    const int4 x = *reinterpret_cast<const int4*>(src + j);
    cnt += (j >= a && x.x >= i) + (j + 1 >= a && j + 1 < b && x.y >= i) +
           (j + 2 >= a && j + 2 < b && x.z >= i) +
           (j + 3 >= a && j + 3 < b && x.w >= i);
  }
  return cnt;
}

// Pass 2: one CTA the T rows of one tile, kLanes lanes a row.
__global__ void __launch_bounds__(kThreads)
tiled_count_kernel(const int* __restrict__ prev, const int* __restrict__ keys,
                   const int* __restrict__ sorted,
                   const int* __restrict__ samples, int* __restrict__ out,
                   int n) {
  __shared__ __align__(16) int sk[kTile];     // the tile's keys
  __shared__ int sp[kTile];                   // its rows' prev
  __shared__ int cov[kTile + 1];              // in-tile coverage
  __shared__ int warp_sums[kThreads / 32];
  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const long long base = tile * kTile;
  for (int t = tid; t <= kTile; t += kThreads) {
    cov[t] = 0;
    const long long j = base + t;
    if (t < kTile) {
      sk[t] = j < n ? keys[j] : kNever;
      sp[t] = j < n ? prev[j] : -1;
    }
  }
  __syncthreads();
  // cov[t + 1] = #{ j in [base, base + t) : key[j] >= base + t } after the
  // scan: key j covers rows j + 1 .. min(key, base + T - 1)
  for (int t = tid; t < kTile; t += kThreads) {
    const long long last = min(static_cast<long long>(sk[t]) - base,
                               static_cast<long long>(kTile - 1));
    if (last > t) {
      atomicAdd(&cov[t + 1], 1);
      atomicAdd(&cov[last + 1], -1);
    }
  }
  __syncthreads();
  block_scan(cov, kTile + 1, warp_sums);
  const int lane = tid & 31;
  const int sub = lane / kLanes;
  const int sl = lane % kLanes;
  constexpr int kRows = 32 / kLanes;          // rows of a warp at once
  for (int r0 = (tid >> 5) * kRows; r0 < kTile; r0 += kThreads / kLanes) {
    const int t = r0 + sub;
    const int p = sp[t];
    const long long i = base + t;
    const long long lo = static_cast<long long>(p) + 1;
    int c = 0;
    if (p >= 0 && i < n) {
      const int row = static_cast<int>(i);
      if (lo > base) {                        // inside this tile
        c = count_direct(sk, lo - base, t, row, sl);
      } else {                                // head, whole tiles, tail
        const long long edge = (lo + kTile - 1) / kTile * kTile;
        c = count_direct(keys, lo, edge, row, sl);
        if (sl == 0) c += cov[t + 1];         // the tail [base, i)
        for (long long k = edge / kTile + sl; k < tile; k += kLanes)
          c += count_ge(sorted, samples, k, row);
      }
    }
    for (int off = kLanes / 2; off > 0; off >>= 1)
      c += __shfl_xor_sync(0xffffffffu, c, off);
    if (sl == 0 && i < n) out[i] = p < 0 ? -1 : c;
  }
}

int launch(const int* prev, const int* nxt, const int* occ, int* out,
           int* scratch, int n, cudaStream_t stream) {
  const long long tiles = n / kTile;
  int* sorted = scratch;                           // tiles * T
  int* samples = sorted + tiles * kTile;           // tiles * T / 16
  int* keys = samples + tiles * (kTile / kBlock);  // n
  const int grid = (n - 1) / kTile + 1;
  sort_tiles_kernel<<<grid, kTile, 0, stream>>>(nxt, occ, keys, sorted,
                                                samples, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tiled_count_kernel<<<grid, kThreads, 0, stream>>>(prev, keys, sorted,
                                                    samples, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: (n / 256) * (256 + 16) + n ints, 16-byte aligned. Returns a
// cudaError_t (0 on success).
extern "C" int cache_sim_scan(const void* prev, const void* nxt,
                              const void* occ, void* out, void* scratch,
                              int n, void* stream) {
  if (n <= 0) return 0;
  return launch(static_cast<const int*>(prev), static_cast<const int*>(nxt),
                static_cast<const int*>(occ), static_cast<int*>(out),
                static_cast<int*>(scratch), n,
                static_cast<cudaStream_t>(stream));
}
