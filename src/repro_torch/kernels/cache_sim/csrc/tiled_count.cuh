// The tiled count on sorted tiles, for Hopper (sm_90a): the device code of
// the port's three interval counts, cache_sim_scan (cache_sim.cu),
// cache_sim_levels_scan (cache_sim_levels.cu) and urd_scan
// (../../urd_scan/csrc/urd_scan.cu), and of cache_sim_segments_scan's
// blocks too wide for shared memory (cache_sim_segments.cu, through a
// prologue that raises prev to the block start). Each of them includes this
// header and is built into a library of its own, so everything here has
// internal linkage.
//
// For every hot row i (prev[i] >= 0) they count
//
//     C[i] = #{ j : prev[i] < j < i,  key[j] >= i }
//
// with key[j] = occ[j] > 0 ? nxt[j] : -1 where there is an occupancy array
// (-1 never counts: a hot row has i >= 1) and key[j] = nxt[j] where there
// is none, and hand C[i] to an epilogue: write it (WriteCount below), or
// compare it with per-row capacities (cache_sim_levels.cu).
//
// Design: two kernels in one call, so that a row's work no longer grows
// with its reuse interval's length.
// - Pass 1 (sort_tiles_kernel): the tape is cut into tiles of T = 256
//   positions (kTile; 128 measured the same and 512 slower at a 16-tenant
//   tape, PERF.md section 6). One CTA a tile loads the keys and, for a
//   whole tile, sorts them in shared memory with a bitonic sort and writes
//   the sorted tile plus every 16th sorted key (the largest of each block
//   of 16, "samples") to scratch. The samples are stored by groups of 4
//   across tiles (group g of tile k at int4 g * n_tiles + k), so that the
//   lanes of a row, which search neighbouring tiles, read neighbouring
//   16-byte words. With an occupancy array pass 1 also writes every
//   position's key (a ragged last tile included); without one the keys are
//   nxt itself and only the whole tiles are launched.
// - Pass 2 (tiled_count_kernel): the rows of one tile are counted by one
//   CTA, or by up to 16 when the tape has too few tiles to fill the card
//   (each recomputes the tile's 256-key coverage and counts its share of
//   the rows; a 1,048,576-row tape keeps one CTA a tile, an 8,000-row one
//   takes 16, without which its 32 CTAs leave most SMs idle). It is a
//   programmatic dependent launch: it starts while pass 1 runs, loads its
//   tile's keys from nxt and occ, scans their coverage, and only then
//   waits for pass 1's sorted tiles (griddepcontrol), which hides a launch
//   and the prologue on short tapes. The interval (prev[i], i) of a row
//   splits into a head up to the first tile edge, the whole tiles strictly
//   inside, and a tail from the row's own tile start to i. The tails of all
//   T rows come at once from an in-tile coverage count (a difference array
//   over the tile's keys and one scan); a row whose interval lies inside its
//   tile and a head (under T positions) are counted by direct compares of
//   the keys, 16-byte vectors over 16 lanes a row; a whole tile is one
//   search for i in its sorted keys, the count of entries >= i: its T / 16
//   samples say which block of 16 holds the first key >= i and that block's
//   16 keys say where in it, two rounds of 16-byte loads; the lanes of a row
//   take different tiles. All rows of a tile run on one SM (or a few), so
//   the sorted tiles just before it, which most of its rows search, are read
//   from L1.
// The work a row is at most T - 1 compares plus one search a whole tile,
// and the count is exact int32 at any length (the TPU kernels' fp32
// accumulators are exact only below 2^24).
//
// Contract. The grids mask their own ragged edge, so any n > 0 works
// without padding, n < T included (no tile is whole then); the caller keeps
// n < 2^31 - 32. The launches go on the caller's stream, and
// launch_tiled_count returns cudaGetLastError() so that a refused launch is
// reported. Scratch: n_tiles * (T + T / 16) ints, plus n with an occupancy
// array, 16-byte aligned, n_tiles = n / T. Without one, nxt must be 16-byte
// aligned (its heads are read as 16-byte vectors).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;                    // T: positions a tile
constexpr int kThreads = 256;                 // pass 2's CTA
constexpr int kLanes = 16;                    // lanes a row, direct parts
constexpr int kRowsAtOnce = kThreads / kLanes;  // rows a CTA counts at once
constexpr int kBlock = 16;                    // sorted keys per sample
constexpr int kNever = -1;                    // the key of a non-occupant
// pass 2 CTAs that fill the card: 8 of 256 threads on each of the H100's
// 132 SMs, about; a tape of fewer tiles splits each tile's rows
constexpr long long kFillCtas = 1024;

// Pass 1: the sorted keys and samples of every whole tile, and, with an
// occupancy array, every position's key.
template <bool kOcc>
__global__ void __launch_bounds__(kTile)
sort_tiles_kernel(const int* __restrict__ nxt, const int* __restrict__ occ,
                  int* __restrict__ keys, int* __restrict__ sorted,
                  int* __restrict__ samples, int n) {
  __shared__ int s[kTile];
  // pass 2 may start now; its griddepcontrol.wait still waits for this
  // grid to finish and its writes to land
  asm volatile("griddepcontrol.launch_dependents;");
  const int t = threadIdx.x;
  const long long j = static_cast<long long>(blockIdx.x) * kTile + t;
  int key = kNever;
  if (j < n) {
    if constexpr (kOcc) {
      key = occ[j] > 0 ? nxt[j] : kNever;
      keys[j] = key;
    } else {
      key = nxt[j];
    }
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
  if (t % kBlock == kBlock - 1) {               // sample si of this tile
    const long long tiles = n / kTile;
    const int si = t / kBlock;
    samples[((si / 4) * tiles + blockIdx.x) * 4 + si % 4] = s[t];
  }
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

// Entries >= i among tile k's sorted keys (of `tiles` whole tiles): the
// tile's T / 16 samples say how many blocks of 16 lie wholly below i, then
// the block of 16 keys they point to says where in it; both read as 16-byte
// vectors.
__device__ __forceinline__ int count_ge(const int* __restrict__ sorted,
                                        const int* __restrict__ samples,
                                        long long k, long long tiles,
                                        int i) {
  constexpr int kSamples = kTile / kBlock;
  const int4* sm = reinterpret_cast<const int4*>(samples) + k;
  int below = 0;                              // blocks whose largest is < i
#pragma unroll
  for (int v = 0; v < kSamples / 4; ++v) {
    const int4 x = __ldg(sm + v * tiles);
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

// The count as it is: -1 at cold rows (a prefix count there would cost
// O(i) and no caller uses it).
struct WriteCount {
  int* out;
  __device__ __forceinline__ void operator()(long long i, bool hot,
                                             int c) const {
    out[i] = hot ? c : -1;
  }
};

// How pass 2 reads a row's prev: as it is (PlainPrev), or through a
// prologue of the caller's (cache_sim_segments.cu raises a hot row's prev
// to its block start).
struct PlainPrev {
  __device__ __forceinline__ int operator()(const int* __restrict__ prev,
                                            long long j) const {
    return prev[j];
  }
};

// Pass 2: the rows of one tile (blockIdx.x), or the blockIdx.y-th of
// gridDim.y equal shares of them, kLanes lanes a row; each row's count
// goes to epilogue(i, prev[i] >= 0, C[i]). Reads nothing of pass 1 before
// its griddepcontrol.wait.
template <bool kOcc, class Epilogue, class PrevOf>
__global__ void __launch_bounds__(kThreads)
tiled_count_kernel(const int* __restrict__ prev, const int* __restrict__ nxt,
                   const int* __restrict__ occ, const int* __restrict__ keys,
                   const int* __restrict__ sorted,
                   const int* __restrict__ samples, Epilogue epilogue,
                   PrevOf prev_of, int n) {
  __shared__ __align__(16) int sk[kTile];     // the tile's keys
  __shared__ int sp[kTile];                   // its rows' prev
  __shared__ int cov[kTile + 1];              // in-tile coverage
  __shared__ int warp_sums[kThreads / 32];
  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const long long base = tile * kTile;
  const long long tiles = n / kTile;          // whole tiles
  for (int t = tid; t <= kTile; t += kThreads) {
    cov[t] = 0;
    const long long j = base + t;
    if (t < kTile) {
      int key = kNever;                       // as pass 1 keys it
      if (j < n) key = !kOcc || occ[j] > 0 ? nxt[j] : kNever;
      sk[t] = key;
      sp[t] = j < n ? prev_of(prev, j) : -1;
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
  asm volatile("griddepcontrol.wait;" ::: "memory");  // pass 1 is done
  const int lane = tid & 31;
  const int sub = lane / kLanes;
  const int sl = lane % kLanes;
  constexpr int kRows = 32 / kLanes;          // rows of a warp at once
  const int share = kTile / static_cast<int>(gridDim.y);
  const int first = static_cast<int>(blockIdx.y) * share;
  for (int r0 = first + (tid >> 5) * kRows; r0 < first + share;
       r0 += kRowsAtOnce) {
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
          c += count_ge(sorted, samples, k, tiles, row);
      }
    }
    for (int off = kLanes / 2; off > 0; off >>= 1)
      c += __shfl_xor_sync(0xffffffffu, c, off);
    if (sl == 0 && i < n) epilogue(i, p >= 0, c);
  }
}

// Both passes on `stream`, every row's count handed to `epilogue`. With
// kOcc the keys are occ[j] > 0 ? nxt[j] : -1 and pass 1 writes them to
// scratch; without it occ is not read and the keys are nxt. Pass 2 is a
// programmatic dependent launch of pass 1; with no whole tile to sort
// (kOcc false, n < T) it is launched alone, in stream order. prev_of reads
// a row's prev (PlainPrev: as it is). Returns a cudaError_t (0 on
// success).
template <bool kOcc, class Epilogue, class PrevOf = PlainPrev>
int launch_tiled_count(const int* prev, const int* nxt, const int* occ,
                       Epilogue epilogue, int* scratch, int n,
                       cudaStream_t stream, PrevOf prev_of = PrevOf()) {
  const long long tiles = n / kTile;
  int* sorted = scratch;                           // tiles * T
  int* samples = sorted + tiles * kTile;           // tiles * T / 16
  int* own_keys = samples + tiles * (kTile / kBlock);  // n, with kOcc
  const int* keys = kOcc ? own_keys : nxt;
  const int grid = (n - 1) / kTile + 1;
  const int sort_grid = kOcc ? grid : static_cast<int>(tiles);
  if (sort_grid > 0) {
    sort_tiles_kernel<kOcc><<<sort_grid, kTile, 0, stream>>>(
        nxt, occ, own_keys, sorted, samples, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int split = 1;                                   // CTAs a tile
  while (split < kTile / kRowsAtOnce && grid * split < kFillCtas) split <<= 1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, split);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = sort_grid > 0 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, tiled_count_kernel<kOcc, Epilogue, PrevOf>, prev, nxt, occ, keys,
      sorted, samples, epilogue, prev_of, n);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
