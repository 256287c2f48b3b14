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
// +1 at every birth j and -1 at every death nxt[j]. A row with
// nxt[j] <= j (a pad row's -1, say) is never live; a death at nxt[j] >= n
// falls outside the tape and is dropped. Every count is an exact int32.
//
// Design: two kernels a call, after one memset, over tiles of kTile rows.
//   1. scatter_kernel, a CTA a tile: loads its rows once and sums, in
//      shared memory, +1 at each birth and -1 at each death that lands in
//      its own tile (the lanes of a warp that die at one position adding
//      once), then adds the tile's nonzero sums to d (cleared by the
//      memset); a death beyond its tile goes to d with a global atomic:
//      those at the furthest position it reaches (a tenant block's end,
//      where thousands of tokens die) once, through a shared counter, the
//      rest a warp's lanes of one position at a time.
//   2. scan_kernel, a programmatic dependent launch of the first (it starts
//      while the scatter runs and waits for it with griddepcontrol): a
//      single-pass scan with decoupled look-back. CTAs take tiles in order
//      from an atomic ticket (cleared by the same memset), so every tile
//      before a CTA's own is held by a running CTA and the look-back cannot
//      deadlock. A CTA scans d over its tile, publishes the tile's sum,
//      looks back for its exclusive prefix (the whole CTA, kThreads tiles
//      a step, summing tile sums until a tile that holds its inclusive
//      prefix: the tiles publish at about the same time, so a narrow
//      window would walk far), publishes its inclusive prefix and writes L
//      once.
// No state outlives the call: the memset clears the ticket, the status
// words and d. The previous design's five stream operations (a memset,
// scatter, tile scan, a single-CTA scan of the tile sums and an offset
// pass) become three. (A single kernel, clearing d itself tile by tile and
// waiting for every earlier tile to scatter before its scan, measured
// slower: each CTA's chain of clearing, scattering, waiting and scanning
// left the card idle, PERF.md section 6.)
//
// What bounds it on the card. The function's floor is its bytes: nxt and
// occ read once and L written once, 12 n bytes; its operations (an add a
// row) do not bound it. This design moves besides those d cleared, added
// to and read (12 n bytes, mostly L2 hits at the pressure tape), and its
// deaths beyond a tile as global atomics, which set its time at the
// 16.8 M-row tapes.
//
// Contract. nxt and occ are int32[n]; L is int32[n]; with tiles =
// ceil(n / 4096), scratch holds ceil((2 tiles + 1) / 4) * 4 + 4096 tiles
// int32 words, 16-byte aligned. The function returns a cudaError_t (0 on
// success; cudaGetLastError() after the launches, so a refused launch is
// reported).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 4;                     // rows a thread
constexpr int kTile = kThreads * kItems;      // 4096 rows a tile
constexpr int kWarps = kThreads / 32;
// status word of a tile: a flag in the high half, a value in the low half
constexpr unsigned long long kAggregate = 1ull << 32;  // value: tile sum
constexpr unsigned long long kPrefix = 2ull << 32;     // value: inclusive

// scratch, all cleared by the memset: status[tiles] (8 bytes each) and
// the ticket, rounded up to 16 bytes, then d (tiles * kTile words)
constexpr long long small_ints(long long tiles) {
  return (2 * tiles + 1 + 3) / 4 * 4;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long flag, int value) {
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(p) =
      flag | static_cast<unsigned int>(value);
}

__device__ __forceinline__ int flag_of(unsigned long long w) {
  return static_cast<int>(w >> 32);
}

__device__ __forceinline__ int value_of(unsigned long long w) {
  return static_cast<int>(static_cast<unsigned int>(w));
}

// 1. births less deaths, summed in shared memory over the tile's own rows,
// then added to d
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ nxt, const int* __restrict__ occ,
               int* __restrict__ d, int n) {
  __shared__ __align__(16) int delta[kTile];
  __shared__ int s_far_at, s_far;
  // the scan may start now; its griddepcontrol.wait still waits for this
  // grid to finish and its writes to land
  asm volatile("griddepcontrol.launch_dependents;");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long end = min(base + kTile, static_cast<long long>(n));
  if (tid == 0) {
    s_far_at = -1;
    s_far = 0;
  }
  int at[kItems];
  int far_at = -1;                            // the furthest death beyond
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int t = it * kThreads + tid;
    const long long j = base + t;
    int x = -1;
    int born = 0;
    if (j < n) {
      const int nx = nxt[j];
      if (occ[j] > 0 && nx > j) {
        born = 1;
        if (nx < n) x = nx;
      }
    }
    delta[t] = born;
    at[it] = x;
    if (x >= end) far_at = max(far_at, x);
  }
  far_at = __reduce_max_sync(0xffffffffu, far_at);
  __syncthreads();
  if (lane == 0 && far_at >= 0) atomicMax(&s_far_at, far_at);
  __syncthreads();
  const int far = s_far_at;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int x = at[it];
    const unsigned peers = __match_any_sync(0xffffffffu, x);
    if (x >= 0 && lane == __ffs(peers) - 1) {
      const int c = __popc(peers);
      if (x < end) {
        atomicAdd(&delta[x - base], -c);
      } else if (x == far) {
        atomicAdd(&s_far, c);
      } else {
        atomicAdd(d + x, -c);
      }
    }
  }
  __syncthreads();
  if (tid == 0 && far >= 0) atomicAdd(d + far, -s_far);
  for (int t = tid; t < kTile; t += kThreads) {
    const int v = delta[t];
    if (v != 0) atomicAdd(d + base + t, v);
  }
}

// 2. the scan with decoupled look-back
__global__ void __launch_bounds__(kThreads)
scan_kernel(const int* __restrict__ d, int* __restrict__ out,
            unsigned long long* status, int* ticket, int n) {
  __shared__ int warp_sums[kWarps];
  __shared__ int s_tile, s_first, s_excl;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) {
    s_tile = atomicAdd(ticket, 1);
    s_excl = 0;
  }
  __syncthreads();
  const int k = s_tile;
  const long long base = static_cast<long long>(k) * kTile;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the scatter is done

  // this thread's kItems consecutive rows, scanned; then the CTA's
  const long long row = base + static_cast<long long>(tid) * kItems;
  int4 v = *reinterpret_cast<const int4*>(d + row);
  v.y += v.x;
  v.z += v.y;
  v.w += v.z;
  int incl = v.w;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int x = lane < kWarps ? warp_sums[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane < kWarps) warp_sums[lane] = x;
  }
  __syncthreads();
  const int before = incl - v.w + (warp > 0 ? warp_sums[warp - 1] : 0);
  const int total = warp_sums[kWarps - 1];

  // the exclusive prefix by look-back, kThreads tiles a step
  if (tid == 0) publish(status + k, k == 0 ? kPrefix : kAggregate, total);
  for (int top = k - 1; top >= 0; top -= kThreads) {   // CTA-uniform
    if (tid == 0) s_first = kThreads;
    __syncthreads();
    const int j = top - tid;
    unsigned long long w = kPrefix;           // before tile 0: prefix 0
    if (j >= 0) {
      do {
        w = load_status(status + j);
      } while (flag_of(w) == 0);
    }
    // the closest tile that holds its inclusive prefix ends the sum
    const int cand = __reduce_min_sync(
        0xffffffffu, w >= kPrefix ? tid : kThreads);
    if (lane == 0) atomicMin(&s_first, cand);
    __syncthreads();
    const int first = s_first;
    const int part = __reduce_add_sync(0xffffffffu,
                                       tid <= first ? value_of(w) : 0);
    if (lane == 0 && part != 0) atomicAdd(&s_excl, part);
    if (first < kThreads) break;
    __syncthreads();
  }
  __syncthreads();
  const int excl = s_excl;
  if (tid == 0 && k > 0) publish(status + k, kPrefix, excl + total);
  const int add = excl + before;
  if (row + kItems <= n) {
    *reinterpret_cast<int4*>(out + row) =
        make_int4(add + v.x, add + v.y, add + v.z, add + v.w);
  } else {
    const int vals[kItems] = {add + v.x, add + v.y, add + v.z, add + v.w};
    for (int q = 0; q < kItems && row + q < n; ++q) out[row + q] = vals[q];
  }
}

}  // namespace

extern "C" int live_count_scan(const void* nxt, const void* occ, void* out,
                               void* scratch, int n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (static_cast<long long>(n) + kTile - 1) / kTile;
  int* small = static_cast<int*>(scratch);
  auto* status = reinterpret_cast<unsigned long long*>(small);
  int* ticket = small + 2 * tiles;
  int* d = small + small_ints(tiles);
  cudaError_t err = cudaMemsetAsync(
      small, 0,
      sizeof(int) * static_cast<size_t>(small_ints(tiles) + tiles * kTile), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<static_cast<int>(tiles), kThreads, 0, s>>>(
      static_cast<const int*>(nxt), static_cast<const int*>(occ), d, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, scan_kernel, static_cast<const int*>(d),
                           static_cast<int*>(out), status, ticket, n);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
