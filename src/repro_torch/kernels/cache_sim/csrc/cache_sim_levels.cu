// cache_sim_levels_scan for Hopper (sm_90a): both-level residency masks of
// the exclusive two-level (ETICA) hierarchy from one counting pass.
//
// Replaces the TPU kernel cache_sim_levels_scan in src/repro/kernels/
// cache_sim/kernel.py:294 (pl.pallas_call at :323), which counts
//
//     SD[i] = #{ j : prev[i] < j < i,  occ[j] > 0,  nxt[j] >= i }
//
// over the whole (i, j) plane in 256 x 256 tiles with an fp32 accumulator
// and compares it in-kernel with two per-row capacities:
//
//     l1[i]    = prev[i] >= 0  and  SD[i] < cap1[i]
//     union[i] = prev[i] >= 0  and  SD[i] < captot[i]
//
// (the union of the two levels is one LRU stack whose top cap1 entries are
// L1, so an L2 hit is union & ~l1).
//
// Design: the tiled count on sorted tiles of tiled_count.cuh, keyed on
// occ[j] > 0 ? nxt[j] : -1 as cache_sim_scan (cache_sim.cu) is, with an
// epilogue that compares the exact count with both capacities. Two kernels
// a call: pass 1 sorts each whole tile of keys, pass 2 counts each row's
// interval as a head by direct compares, one search in each sorted whole
// tile after it and a tail from its own tile's coverage count. A row's work
// is at most T - 1 compares plus one search a whole tile, whatever its
// capacities. The count is exact, so the masks are the function's for any
// capacities, cap1 > captot and zeros included, and no row stops early: a
// stop at captot[i] would need cap1 <= captot, and the whole count costs
// about what cache_sim_scan's does (PERF.md section 6).
//
// What bounds it on the card. The function's floor is its bytes: reading
// prev, nxt, occ, cap1 and captot once and writing the two masks is 28 n
// bytes. Its operations do not bound it (a Fenwick-tree count needs
// n * ceil(log2 n) of them). The two passes move about 16 n bytes more
// (keys and sorted tiles written, then read) plus the head and tail
// compares and the searches, most of them L1 and L2 hits: the compares,
// not the floor, set the time, as for cache_sim_scan.
//
// Contract. Cold rows (prev[i] < 0) write 0 to both masks. Any n works
// without padding; the caller keeps n < 2^31 - 32. The launches go on the
// caller's stream and the function returns cudaGetLastError() so a refused
// launch is reported.

#include "tiled_count.cuh"

namespace {

struct CompareLevels {
  const int* cap1;
  const int* captot;
  int* l1;
  int* un;
  __device__ __forceinline__ void operator()(long long i, bool hot,
                                             int c) const {
    l1[i] = hot && c < cap1[i];
    un[i] = hot && c < captot[i];
  }
};

}  // namespace

// scratch: (n / 256) * (256 + 16) + n ints, 16-byte aligned, as
// cache_sim_scan's. Returns a cudaError_t (0 on success).
extern "C" int cache_sim_levels_scan(const void* prev, const void* nxt,
                                     const void* occ, const void* cap1,
                                     const void* captot, void* l1, void* un,
                                     void* scratch, int n, void* stream) {
  if (n <= 0) return 0;
  const CompareLevels epilogue{
      static_cast<const int*>(cap1), static_cast<const int*>(captot),
      static_cast<int*>(l1), static_cast<int*>(un)};
  return launch_tiled_count<true>(
      static_cast<const int*>(prev), static_cast<const int*>(nxt),
      static_cast<const int*>(occ), epilogue, static_cast<int*>(scratch), n,
      static_cast<cudaStream_t>(stream));
}
