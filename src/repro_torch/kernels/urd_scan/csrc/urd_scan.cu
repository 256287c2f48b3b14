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
// Design. Row i only needs j inside its own reuse interval (prev[i], i), so
// one warp per row walks that interval 32 positions at a time: lane k reads
// nxt[prev[i] + 1 + k], + 32, ..., so neighbouring lanes read neighbouring
// words (coalesced). Each lane counts in int32 and the warp reduces with
// shuffles. The total work is the sum of the reuse intervals, not n^2, and
// the int32 count is exact at any length (the TPU's fp32 accumulator is
// exact only below 2^24). It reads no occupancy array: this is the count of
// cache_sim_scan (src/repro_torch/kernels/cache_sim/csrc/cache_sim.cu)
// with every position occupying, and it moves a quarter fewer bytes.
//
// What bounds it on the card. The function's floor is its bytes: reading
// prev and nxt once and writing the output once is 12 n bytes (three int32
// arrays). Its operations do not bound it, since a Fenwick-tree count needs
// only n * ceil(log2 n) of them. This design does sum_i (i - prev[i] - 1)
// compares over hot rows, far more than either: rows whose intervals
// overlap re-read the same nxt words, which L1 and L2 absorb. That work,
// not the floor, sets its time.
//
// Contract. Cold rows (prev[i] < 0) write -1, as cache_sim_scan does (the
// TPU kernel returns a prefix count there, which its callers mask; no
// caller uses it). The grid masks its own ragged edge, so any n works
// without padding; the caller keeps n < 2^31 - 32 so that j + 32 never
// overflows. The launch goes on the caller's stream and the function
// returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void urd_scan_kernel(const int* __restrict__ prev,
                                const int* __restrict__ nxt,
                                int* __restrict__ out, int n) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // warp-uniform: the whole warp leaves together
  const int i = static_cast<int>(row);
  const int p = prev[i];
  if (p < 0) {           // warp-uniform as well
    if (lane == 0) out[i] = -1;
    return;
  }
  int cnt = 0;
  for (int j = p + 1 + lane; j < i; j += 32) {
    cnt += nxt[j] >= i;
  }
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  if (lane == 0) out[i] = cnt;
}

}  // namespace

extern "C" int urd_scan(const void* prev, const void* nxt, void* out, int n,
                        void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  urd_scan_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(prev), static_cast<const int*>(nxt),
      static_cast<int*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
