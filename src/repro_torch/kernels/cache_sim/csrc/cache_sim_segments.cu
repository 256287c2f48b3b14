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
// Design. The restriction to one aligned block is what the design uses:
// a thread block owns a tile of kRows consecutive rows, and the j values
// those rows need all lie in [tile_lo, last row), where tile_lo is the
// smallest start max(prev[i] + 1, block start of i) over the tile's hot
// rows, so the range never leaves the rows' own w-blocks (a tile that
// straddles two blocks, when w < kRows, clamps each row to its own).
// That range is staged through shared memory in chunks of kChunk words,
// each word nxt[j] where occ[j] > 0 and -1 elsewhere (a count needs only
// "nxt[j] >= i", and i >= 0). Every warp then counts its kRowsPerWarp
// rows against the chunk from shared memory: lane k takes j = a + k,
// a + k + 32, ..., so a warp reads consecutive words (no bank
// conflicts), and each row keeps one int32 count per lane in a register,
// reduced with shuffles at the end. A range longer than one chunk (a
// segment wider than kChunk, or a row whose reuse interval starts
// chunks back) loops over chunks; the chunk loop is uniform across the
// thread block, so its barriers are too.
//
// What bounds it on the card. The function's floor is its bytes: prev,
// nxt, occ and the output, four int32 arrays, 16 m bytes. Its operations
// do not bound it: a merge-sort-tree count needs m * log2(w) of them.
// This design does sum_i (i - max(prev[i] + 1, block start) - 1) compares
// from shared memory and stages each tile's range once, up to w words a
// tile of kRows rows, so its time is set by that work, far above the
// floor. Making it fast (a tree count, or sharing staged ranges across
// tiles) is later work.
//
// Contract. Cold rows (prev[i] < 0), which include the pad rows of a
// padded tape, write -1. m must be a multiple of w and below 2^31 - 2^14
// (the caller refuses larger tapes, so every position and chunk end fits
// int32). The launch goes on the caller's stream and the function returns
// cudaGetLastError() so a refused launch is reported.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 16;
constexpr int kRows = kWarps * kRowsPerWarp;  // 128 rows per thread block
constexpr int kChunk = 4096;                  // staged j words (16 KB)

__global__ void __launch_bounds__(kThreads)
cache_sim_segments_kernel(const int* __restrict__ prev,
                          const int* __restrict__ nxt,
                          const int* __restrict__ occ,
                          int* __restrict__ out, int m, int w) {
  __shared__ int s_val[kChunk];
  __shared__ int s_lo[kRows];   // first j of each row's range (empty: row)
  __shared__ int s_tile_lo;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * kRows;
  const int r1 = min(r0 + kRows, m);

  if (tid == 0) s_tile_lo = INT_MAX;
  __syncthreads();
  if (tid < kRows) {
    const int i = r0 + tid;
    int lo = i;                 // cold, past the end, or empty: no range
    if (i < m) {
      const int p = prev[i];
      if (p >= 0) {
        lo = min(max(p + 1, i - i % w), i);
        if (lo < i) atomicMin(&s_tile_lo, lo);
      }
    }
    s_lo[tid] = lo;
  }
  __syncthreads();
  const int tile_lo = s_tile_lo;
  const int tile_hi = r1 - 1;   // j < i <= r1 - 1

  int cnt[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) cnt[k] = 0;

  for (int c0 = tile_lo; c0 < tile_hi; c0 += kChunk) {
    const int c1 = min(c0 + kChunk, tile_hi);
    __syncthreads();            // every warp is done with the last chunk
    for (int j = c0 + tid; j < c1; j += kThreads) {
      s_val[j - c0] = occ[j] > 0 ? nxt[j] : -1;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int row = warp * kRowsPerWarp + k;
      const int i = r0 + row;
      const int a = max(s_lo[row], c0);
      const int b = min(i, c1);
      for (int j = a + lane; j < b; j += 32) {
        cnt[k] += s_val[j - c0] >= i;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    int c = cnt[k];
    for (int off = 16; off > 0; off >>= 1) {
      c += __shfl_down_sync(0xffffffffu, c, off);
    }
    const int i = r0 + warp * kRowsPerWarp + k;
    if (lane == 0 && i < m) out[i] = prev[i] < 0 ? -1 : c;
  }
}

}  // namespace

extern "C" int cache_sim_segments_scan(const void* prev, const void* nxt,
                                       const void* occ, void* out, int m,
                                       int w, void* stream) {
  if (m <= 0) return 0;
  if (w <= 0 || m % w != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (m + kRows - 1) / kRows;
  cache_sim_segments_kernel<<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(prev), static_cast<const int*>(nxt),
      static_cast<const int*>(occ), static_cast<int*>(out), m, w);
  return static_cast<int>(cudaGetLastError());
}
