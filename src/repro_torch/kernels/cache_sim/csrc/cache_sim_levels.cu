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
// Design. As in cache_sim.cu, one warp per row walks the row's own reuse
// interval (prev[i], i) 32 positions at a time, neighbouring lanes on
// neighbouring words of nxt and occ. The warp counts each stride's 32
// contributions with one ballot and popcount, so every lane holds the same
// running count, and after every kUnroll strides it stops the row if the
// count has reached captot[i]: past that point both masks are 0 whatever
// the rest of the interval holds (cap1 <= captot), so the early stop is
// exact. A row's work is therefore at most the interval, and about the
// strides it takes to reach captot[i] when that comes first. (A first
// version tested after every stride, so each load waited for the ballot
// before it; in one run it took 2.2x cache_sim.cu's time, PERF.md.)
//
// What bounds it on the card. The function's floor is its bytes: reading
// prev, nxt, occ, cap1 and captot once and writing the two masks is 28 n
// bytes. Its operations do not bound it (a Fenwick-tree count needs
// n * ceil(log2 n) of them). This design reads nxt/occ words again for
// every row whose interval covers them, up to the early stop; L1 and L2
// absorb most of that, and it, not the floor, sets the time.
//
// Contract. Cold rows (prev[i] < 0) write 0 to both masks. The grid masks
// its own ragged edge, so any n works without padding; the caller keeps
// n < 2^31 - 128 so that j + 32 * kUnroll never overflows, and
// cap1 <= captot. The
// launch goes on the caller's stream and the function returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;  // 32-word strides a warp reads per exit test

__global__ void cache_sim_levels_kernel(const int* __restrict__ prev,
                                        const int* __restrict__ nxt,
                                        const int* __restrict__ occ,
                                        const int* __restrict__ cap1,
                                        const int* __restrict__ captot,
                                        int* __restrict__ l1,
                                        int* __restrict__ un, int n) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // warp-uniform: the whole warp leaves together
  const int i = static_cast<int>(row);
  const int p = prev[i];
  const int c1 = cap1[i];
  const int ct = captot[i];
  if (p < 0 || ct <= 0) {  // warp-uniform: cold row, or no capacity at all
    if (lane == 0) {
      l1[i] = 0;
      un[i] = 0;
    }
    return;
  }
  int cnt = 0;  // the same in every lane: each step adds popcounts
  for (int base = p + 1; base < i; base += 32 * kUnroll) {
    // kUnroll independent loads a lane before the exit test, so the
    // early stop does not serialise the loads
    int step = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + 32 * u + lane;
      const bool hit = (j < i) && (nxt[j] >= i) && (occ[j] > 0);
      step += __popc(__ballot_sync(0xffffffffu, hit));
    }
    cnt += step;
    if (cnt >= ct) break;  // warp-uniform; both masks are 0 from here on
  }
  if (lane == 0) {
    l1[i] = cnt < c1 ? 1 : 0;
    un[i] = cnt < ct ? 1 : 0;
  }
}

}  // namespace

extern "C" int cache_sim_levels_scan(const void* prev, const void* nxt,
                                     const void* occ, const void* cap1,
                                     const void* captot, void* l1, void* un,
                                     int n, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cache_sim_levels_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(prev), static_cast<const int*>(nxt),
      static_cast<const int*>(occ), static_cast<const int*>(cap1),
      static_cast<const int*>(captot), static_cast<int*>(l1),
      static_cast<int*>(un), n);
  return static_cast<int>(cudaGetLastError());
}
