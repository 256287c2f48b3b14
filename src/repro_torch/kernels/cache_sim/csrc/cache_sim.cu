// cache_sim_scan for Hopper (sm_90a): occupancy-masked LRU stack distances.
//
// Replaces the TPU kernel cache_sim_scan in src/repro/kernels/cache_sim/
// kernel.py:63 (pl.pallas_call at :84), which counts
//
//     SD[i] = #{ j : prev[i] < j < i,  occ[j] > 0,  nxt[j] >= i }
//
// over the whole (i, j) plane in 256 x 256 tiles with an fp32 accumulator.
//
// Design: the tiled count on sorted tiles of tiled_count.cuh (shared with
// cache_sim_levels.cu and urd_scan.cu), keyed on occ[j] > 0 ? nxt[j] : -1,
// with the count written. Two kernels a call: pass 1 sorts each whole tile
// of keys, pass 2 counts each row's interval as a head by direct compares,
// one search in each sorted whole tile after it and a tail from its own
// tile's coverage count. The work a row is at most T - 1 compares plus one
// search a whole tile: on a 16-tenant MSR window at T = 256 about a tenth
// of the previous design's sum of interval lengths.
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
// cost O(i) and no caller uses it). Any n works without padding; the
// caller keeps n < 2^31 - 32. The launches go on the caller's stream and
// the function returns cudaGetLastError() so a refused launch is reported.

#include "tiled_count.cuh"

// scratch: (n / 256) * (256 + 16) + n ints, 16-byte aligned. Returns a
// cudaError_t (0 on success).
extern "C" int cache_sim_scan(const void* prev, const void* nxt,
                              const void* occ, void* out, void* scratch,
                              int n, void* stream) {
  if (n <= 0) return 0;
  return launch_tiled_count<true>(
      static_cast<const int*>(prev), static_cast<const int*>(nxt),
      static_cast<const int*>(occ), WriteCount{static_cast<int*>(out)},
      static_cast<int*>(scratch), n, static_cast<cudaStream_t>(stream));
}
