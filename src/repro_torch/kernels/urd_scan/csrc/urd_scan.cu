// urd_scan for Hopper (sm_90a): reuse distances from occurrence links.
//
// Replaces the TPU kernel urd_scan in src/repro/kernels/urd_scan/kernel.py:62
// (pl.pallas_call at :82), which counts
//
//     RD[i] = #{ j : prev[i] < j < i,  nxt[j] >= i }
//
// over the whole (i, j) plane in 256 x 256 tiles with an fp32 accumulator.
// Each j in the interval with nxt[j] >= i is the last occurrence, before i,
// of a distinct address touched since prev[i]: RD[i] is the number of
// distinct addresses between two touches of the same block (the per-tenant
// Analyzer's URD/TRD sample before the read/write mask).
//
// Design: the count of cache_sim_scan with every position occupying, so it
// is the tiled count on sorted tiles of the shared header
// src/repro_torch/kernels/cache_sim/csrc/tiled_count.cuh, included below by
// its path relative to this file, keyed on nxt itself: no occupancy array
// is read and no key array is written. Two kernels a call: pass 1 sorts
// each whole 256-position tile of nxt, pass 2 (launched as its programmatic
// dependent) counts each row's interval as a head by direct compares, one
// search in each sorted whole tile after it and a tail from its own tile's
// coverage count. A row's work is at most 255 compares plus one search a
// whole tile, not its interval's length (up to 34,148 positions in a
// 65,536-access MSR window). The Analyzer's tapes are short (8,000 to
// 65,536 rows, 32 to 256 tiles), so pass 2 splits each tile's rows over
// several CTAs to fill the card.
//
// What bounds it on the card. The function's floor is its bytes: reading
// prev and nxt once and writing the output once is 12 n bytes (three int32
// arrays). Its operations do not bound it, since a Fenwick-tree count needs
// only n * ceil(log2 n) of them. Neither sets the time. At a million rows
// the heads' compares and the searches' L1 and L2 requests do, as for
// cache_sim_scan. At the Analyzer's tapes the latency of the chain does:
// two dependent kernels, then in pass 2 a tile's load, its coverage scan,
// a head and the rounds of searches of a warp's rows. There a walk of each
// interval by a warp a row ties it at a 65,536-row window and is faster at
// an 8,000-row one (PERF.md section 6).
//
// Contract. Cold rows (prev[i] < 0) write -1, as cache_sim_scan does (the
// TPU kernel returns a prefix count there, which its callers mask; no
// caller uses it). Any n works without padding; the caller keeps
// n < 2^31 - 32 and nxt 16-byte aligned. The launches go on the caller's
// stream and the function returns cudaGetLastError() so a refused launch
// is reported.

#include "../../cache_sim/csrc/tiled_count.cuh"

// scratch: (n / 256) * (256 + 16) ints, 16-byte aligned. Returns a
// cudaError_t (0 on success).
extern "C" int urd_scan(const void* prev, const void* nxt, void* out,
                        void* scratch, int n, void* stream) {
  if (n <= 0) return 0;
  return launch_tiled_count<false>(
      static_cast<const int*>(prev), static_cast<const int*>(nxt), nullptr,
      WriteCount{static_cast<int*>(out)}, static_cast<int*>(scratch), n,
      static_cast<cudaStream_t>(stream));
}
