// RO (write-around) eviction-token replays for Hopper (sm_90a).
//
// These kernels replace no TPU kernel. The reference replays an RO tenant
// whose window overflows its partition with a host loop
// (src/repro/core/batch_sim.py:539 _ro_token_replay, :589
// _ro_token_replay_levels) or, on a TPU host, a lax.fori_loop of one step
// an access (ro_token_replay_device, :726; ro_token_replay_levels_device,
// :845). In the port the loop is the manager's replay hot path (the
// ro_replay stage, seconds a window at 256 tenants), and a sequential loop
// written as torch operations would be one launch an access, so it is a
// kernel.
//
// The replay. Every read position j of a tenant's block is a cache-slot
// token alive on [j, nxt[j]). A read that misses installs its token; when
// the partition overflows, the oldest live token is evicted (death[j] set
// to the evicting position). Eviction order is token-position order, so
// the victim is the minimum live token and never moves backwards: one
// forward pointer b finds it. A write that re-touches a live token frees
// its slot (write-around invalidation). Access i hits iff its previous
// occurrence p was a read whose token lived to i (death[p] == i). The
// two-level replay gives each token a level: installs go to L1, an L1
// overflow demotes L1's minimum live token into L2 (pointer b1, skipping
// tokens already in L2), an L2 overflow evicts the minimum live token
// (pointer b2; always an L2 token, since live L1 positions sit above every
// live L2 position); positions below l2_end are the warm-L2 pseudo-reads,
// born in L2; clean2 flushes a dirty victim at its demotion.
//
// Design. One CTA a tenant block. Its threads first lay the block out in
// the outputs (death = the local next occurrence, dirty = the forced flag,
// lvl = 1), then thread 0 walks the block serially in local int32
// positions with the pointers b, b1 and b2 and the occupancy counters in
// registers, and writes the block's flushes (and demotions) once. The
// blocks of all pressured tenants run in parallel, one launch a window
// for the single-level tenants and one for the two-level ones.
//
// What bounds it on the card. Each step reads its own row (streamed) and
// then the row of its previous occurrence, whose death word an earlier
// step may have written: a chain of dependent loads, at best one L1 hit a
// step. So the function's floor is the larger of its bytes (16 or 17 a
// row, read once and written once) at the memory rate and the longest
// block's rows times an L1 hit's latency; at the paths' shapes the chain
// bounds it by far. The design does nothing yet to shorten the chain.
//
// Contract. rd and force are bool (one byte) a row of the whole tape,
// prev and nxt int32 global positions (links severed at the tenant
// blocks, nxt clamped to the block end). desc holds, a block each, int64
// (start, end, out) and the capacities: cap for the single level;
// cap1, cap2, l2_end (local), clean2 for two levels. death (int32, local
// positions), dirty (byte) and lvl (int8) are written at out + t for the
// block's rows; counts holds the flushes of block k at k and, for two
// levels, its demotions at K + k. Returns cudaGetLastError() after the
// launch (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSingleDesc = 4;   // start, end, out, cap
constexpr int kLevelsDesc = 7;   // start, end, out, cap1, cap2, l2_end, clean2

__global__ void __launch_bounds__(kThreads)
ro_replay_kernel(const uint8_t* __restrict__ rd_all,
                 const int* __restrict__ prev_all,
                 const int* __restrict__ nxt_all,
                 const uint8_t* __restrict__ force_all,
                 const long long* __restrict__ desc, int* death_all,
                 uint8_t* dirty_all, long long* counts) {
  const long long* d = desc + kSingleDesc * blockIdx.x;
  const long long s = d[0];
  const int n = static_cast<int>(d[1] - s);
  const int cap = static_cast<int>(d[3]);
  const int base = static_cast<int>(s);
  const uint8_t* rd = rd_all + s;
  const int* pv = prev_all + s;
  int* death = death_all + d[2];
  uint8_t* dirty = dirty_all + d[2];
  for (int t = threadIdx.x; t < n; t += kThreads) {
    death[t] = nxt_all[s + t] - base;
    dirty[t] = force_all[s + t];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  long long flushes = 0;
  int resident = 0;
  int b = 0;                                   // oldest-resident candidate
  for (int t = 0; t < n; ++t) {
    const int p = pv[t] - base;                // < 0: no previous occurrence
    const bool hit = p >= 0 && rd[p] && death[p] == t;
    if (rd[t]) {
      if (hit) {
        dirty[t] = dirty[p];                   // hit: token renewal
      } else if (++resident > cap) {           // miss: install clean
        while (!rd[b] || death[b] <= t) ++b;
        death[b] = t;                          // evict the oldest resident
        flushes += dirty[b];
        --resident;
      }
    } else if (hit) {
      --resident;                              // write-hit: invalidate
    }
  }
  counts[blockIdx.x] = flushes;
}

__global__ void __launch_bounds__(kThreads)
ro_replay_levels_kernel(const uint8_t* __restrict__ rd_all,
                        const int* __restrict__ prev_all,
                        const int* __restrict__ nxt_all,
                        const uint8_t* __restrict__ force_all,
                        const long long* __restrict__ desc, int* death_all,
                        uint8_t* dirty_all, int8_t* lvl_all,
                        long long* counts) {
  const long long* d = desc + kLevelsDesc * blockIdx.x;
  const long long s = d[0];
  const int n = static_cast<int>(d[1] - s);
  const int cap1 = static_cast<int>(d[3]);
  const int cap2 = static_cast<int>(d[4]);
  const int l2_end = static_cast<int>(d[5]);
  const bool clean2 = d[6] != 0;
  const int base = static_cast<int>(s);
  const uint8_t* rd = rd_all + s;
  const int* pv = prev_all + s;
  int* death = death_all + d[2];
  uint8_t* dirty = dirty_all + d[2];
  int8_t* lvl = lvl_all + d[2];
  for (int t = threadIdx.x; t < n; t += kThreads) {
    death[t] = nxt_all[s + t] - base;
    dirty[t] = force_all[s + t];
    lvl[t] = t < l2_end ? 2 : 1;               // warm-L2 tokens: born in L2
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  long long flushes = 0, demotions = 0;
  int res1 = 0, res2 = 0;
  int b1 = 0, b2 = 0;                          // per-level victim candidates
  for (int t = 0; t < n; ++t) {
    if (t < l2_end) {
      ++res2;
      continue;
    }
    const int p = pv[t] - base;
    const bool hit = p >= 0 && rd[p] && death[p] == t;
    if (rd[t]) {
      if (hit) {
        dirty[t] = dirty[p];                   // hit: token renewal
        if (lvl[p] == 1) continue;             // L1 hit: occupancy unchanged
        --res2;                                // L2 hit: promote out of L2
      }
      if (++res1 > cap1) {                     // install / rebirth into L1
        while (!rd[b1] || death[b1] <= t || lvl[b1] == 2) ++b1;
        lvl[b1] = 2;                           // demote into L2's MRU
        if (clean2 && dirty[b1]) {
          ++flushes;                           // flush at the demotion
          dirty[b1] = 0;
        }
        --res1;
        ++demotions;
        if (++res2 > cap2) {
          while (!rd[b2] || death[b2] <= t) ++b2;
          death[b2] = t;                       // evicted for good
          flushes += dirty[b2];
          --res2;
        }
      }
    } else if (hit) {
      if (lvl[p] == 1) --res1;                 // write-hit: invalidate the
      else --res2;                             // holding level (a hole)
    }
  }
  counts[blockIdx.x] = flushes;
  counts[gridDim.x + blockIdx.x] = demotions;
}

}  // namespace

extern "C" int ro_token_replay_scan(const void* rd, const void* prev,
                                    const void* nxt, const void* force,
                                    const void* desc, void* death,
                                    void* dirty, void* counts, int blocks,
                                    void* stream) {
  if (blocks <= 0) return 0;
  ro_replay_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rd), static_cast<const int*>(prev),
      static_cast<const int*>(nxt), static_cast<const uint8_t*>(force),
      static_cast<const long long*>(desc), static_cast<int*>(death),
      static_cast<uint8_t*>(dirty), static_cast<long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ro_token_replay_levels_scan(const void* rd, const void* prev,
                                           const void* nxt, const void* force,
                                           const void* desc, void* death,
                                           void* dirty, void* lvl,
                                           void* counts, int blocks,
                                           void* stream) {
  if (blocks <= 0) return 0;
  ro_replay_levels_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rd), static_cast<const int*>(prev),
      static_cast<const int*>(nxt), static_cast<const uint8_t*>(force),
      static_cast<const long long*>(desc), static_cast<int*>(death),
      static_cast<uint8_t*>(dirty), static_cast<int8_t*>(lvl),
      static_cast<long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
