// live_count_scan for Hopper (sm_90a): the RO write-around live count.
//
// Replaces the TPU kernel live_count_scan in src/repro/kernels/cache_sim/
// kernel.py:220 (pl.pallas_call at :242), which counts
//
//     L[i] = #{ j <= i : occ[j] > 0,  nxt[j] > i }
//
// over the whole (i, j) plane in 256 x 256 tiles with an fp32 accumulator.
// That is O(n^2) work for an O(n) function: each occupying row j with
// nxt[j] > j is a token alive on [j, nxt[j]), so L is the prefix sum of
// +1 at every birth j and -1 at every death nxt[j].
//
// Design, in one call on the caller's stream:
//   1. zero an int32 scratch d[0, n) (cudaMemsetAsync);
//   2. scatter: thread j adds +1 at d[j] and -1 at d[nxt[j]] when
//      occ[j] > 0 and nxt[j] > j (the definition's own condition: a row
//      with nxt[j] <= j, such as a pad row's -1, is never live). Deaths at
//      nxt[j] >= n fall outside [0, n) and are dropped. The adds are
//      atomics. Many tokens die at the same position (links clamped to a
//      tenant block's end, thousands on one word), so a warp first groups
//      its lanes by death position (__match_any_sync) and each group adds
//      once;
//   3. scan each tile of kTile words with one block: 1024 threads scan
//      1024 words at a time with warp shuffles and carry the running sum
//      across the tile's sub-tiles; the tile's total goes to tile_sums;
//   4. one block turns tile_sums into exclusive offsets, 1024 at a time
//      with a carried sum;
//   5. every tile but the first adds its offset.
// Every count is an exact int32 (n < 2^31, and a count is at most n).
//
// What bounds it on the card. The function's floor is its bytes: nxt and
// occ read once and L written once, 12 n bytes. Its operations (one add a
// row for a scan) do not bound it. This design moves the scratch d four
// more times (memset, scatter, read, and L read and written again in the
// offset pass), about 28 n bytes, and pays five launches; at the tapes of
// the main path (10^6 to 1.7 x 10^7 rows) the launches and the atomics on
// the death words that a whole tenant shares are what a later version
// would cut further.
//
// Contract. nxt and occ are int32[n]; L is int32[n]; scratch holds
// n + ceil(n / kTile) int32 words. The function returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 8;                     // sub-tiles of a tile
constexpr int kTile = kThreads * kItems;      // 8192 words a tile

__global__ void scatter_kernel(const int* __restrict__ nxt,
                               const int* __restrict__ occ,
                               int* __restrict__ d, int n) {
  // every lane of a warp reaches the match below (blockDim is a multiple
  // of 32), so no lane leaves early
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int x = j < n ? nxt[j] : 0;
  const bool tok = j < n && occ[j] > 0 && x > j;
  if (tok) atomicAdd(d + j, 1);
  // deaths: the lanes of a warp that die at one position add once, from
  // the lowest of them
  const int at = (tok && x < n) ? x : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, at);
  if (at >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(d + at, -__popc(peers));
  }
}

// Inclusive scan of v over the block (kThreads threads); warp_sums holds
// kThreads / 32 words of shared memory. Ends with a barrier, so the
// caller may reuse warp_sums.
__device__ int block_inclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += t;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];  // kThreads / 32 == 32 warps
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += t;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  __syncthreads();
  return v;
}

__global__ void tile_scan_kernel(const int* __restrict__ d,
                                 int* __restrict__ out,
                                 int* __restrict__ tile_sums, int n) {
  __shared__ int warp_sums[kThreads / 32];
  __shared__ int total;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  int carry = 0;
  for (int k = 0; k < kItems; ++k) {
    const long long idx = base + static_cast<long long>(k) * kThreads +
                          threadIdx.x;
    const int v = idx < n ? d[idx] : 0;
    const int s = block_inclusive_scan(v, warp_sums);
    if (idx < n) out[idx] = s + carry;
    if (threadIdx.x == kThreads - 1) total = s;
    __syncthreads();
    carry += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = carry;
}

// One block: tile_sums -> exclusive prefix offsets, in place.
__global__ void tile_offsets_kernel(int* __restrict__ tile_sums, int tiles) {
  __shared__ int warp_sums[kThreads / 32];
  __shared__ int total;
  int carry = 0;
  for (int base = 0; base < tiles; base += kThreads) {
    const int idx = base + threadIdx.x;
    const int v = idx < tiles ? tile_sums[idx] : 0;
    const int s = block_inclusive_scan(v, warp_sums);
    if (idx < tiles) tile_sums[idx] = s - v + carry;
    if (threadIdx.x == kThreads - 1) total = s;
    __syncthreads();
    carry += total;
    __syncthreads();
  }
}

__global__ void add_offsets_kernel(int* __restrict__ out,
                                   const int* __restrict__ tile_offs,
                                   int n) {
  const int off = tile_offs[blockIdx.x + 1];  // tile 0 needs no offset
  const long long base = static_cast<long long>(blockIdx.x + 1) * kTile;
  for (int k = 0; k < kItems; ++k) {
    const long long idx = base + static_cast<long long>(k) * kThreads +
                          threadIdx.x;
    if (idx < n) out[idx] += off;
  }
}

}  // namespace

extern "C" int live_count_scan(const void* nxt, const void* occ, void* out,
                               void* scratch, int n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* d = static_cast<int*>(scratch);
  const int tiles = (n + kTile - 1) / kTile;
  int* tile_sums = d + n;
  cudaError_t err = cudaMemsetAsync(d, 0, sizeof(int) * static_cast<size_t>(n), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const int*>(nxt), static_cast<const int*>(occ), d, n);
  tile_scan_kernel<<<tiles, kThreads, 0, s>>>(d, static_cast<int*>(out),
                                              tile_sums, n);
  if (tiles > 1) {
    tile_offsets_kernel<<<1, kThreads, 0, s>>>(tile_sums, tiles);
    add_offsets_kernel<<<tiles - 1, kThreads, 0, s>>>(
        static_cast<int*>(out), tile_sums, n);
  }
  return static_cast<int>(cudaGetLastError());
}
