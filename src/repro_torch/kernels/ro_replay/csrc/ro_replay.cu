// RO (write-around) eviction-token replays for Hopper (sm_90a).
//
// These kernels replace no TPU kernel. The reference replays an RO tenant
// whose window overflows its partition with a host loop
// (src/repro/core/batch_sim.py:539 _ro_token_replay, :589
// _ro_token_replay_levels) or, on a TPU host, a lax.fori_loop of one step
// an access (ro_token_replay_device, :726; ro_token_replay_levels_device,
// :845). In the port the loop is the manager's replay hot path (the
// ro_replay stage), and a sequential loop written as torch operations
// would be one launch an access, so it is a kernel.
//
// The replay. Every read position j of a tenant's block is a cache-slot
// token alive on [j, nxt[j]). A read that misses installs its token; when
// the partition overflows, the oldest live token is evicted (death[j] set
// to the evicting position). Eviction order is token-position order, so
// the victim is the minimum live token and never moves backwards. A write
// that re-touches a live token frees its slot (write-around invalidation).
// Access t hits iff its previous occurrence p is a read whose token lived
// to t. The two-level replay gives each token a level: installs go to L1,
// an L1 overflow demotes L1's minimum live token into L2, an L2 overflow
// evicts the minimum live token (always an L2 one: live L1 positions sit
// above every live L2 position); positions below l2_end are the warm-L2
// pseudo-reads, born in L2; clean2 flushes a dirty token at its demotion.
//
// The walk reads nothing it writes. Each victim pointer steps past every
// token it acts on (b for evictions; b2 and b1, from 0 and l2_end, with
// two levels). Every read token below the pointer that is still alive by
// its links was acted on, and none at or above it was. So, with
// cand[t] = p + 1 when the previous occurrence p of t is a read (else 0)
// and live_to[j] = nxt[j] for a read (else -1):
//   t hits (p's token not evicted)  iff  cand[t] > b   (b2 with two levels)
//   p sits in L1                    iff  cand[t] > b1
//   the next victim is the first j >= b with live_to[j] > t.
// cand and live_to are read-only, so the walk's whole state is a few
// registers (resident counts, pointers), and the dirty bits, which never
// steer the walk, come after it: a read hit is born with its parent's
// final flag, any other row with its forced one, a token demoted under
// clean2 ends with 0 (and flushes its birth flag), and every victim
// (death < nxt) flushes its final flag.
//
// Design. One CTA of 256 threads a tenant block, three phases.
//  1. All threads lay out death = nxt (local) and lvl (2 below l2_end).
//  2. Warp 0 walks the block, every lane in step (uniform control flow);
//     warps 1-3 are producers. Each producer stages one stream into a
//     ring of kStages tiles of kR words in shared memory, ahead of the
//     walker, with a full and a freed counter per ring: the t stream
//     (warp 1: a word a row, the read bit in the sign and cand below it;
//     the gather of is_read[p] happens here, off the walk) and each
//     pointer stream (warp 2: b, or b2 from 0; warp 3: b1 from l2_end;
//     live_to a row). The pointers never pass t + 1 but trail it by an
//     unbounded distance, so each has its own ring. A producer issues a
//     tile's loads together, so a tile costs a few memory latencies.
//     The walker takes the t stream kU words a group, each group loaded
//     one group ahead. A step's count change is is_read - [cand > b], two
//     integer operations and no branch, so in the single-level walk a
//     group whose count stays within its cap (its prefix sums against the
//     headroom, with the pointer fixed) is taken at once, and a group that
//     overflows is walked step by step; the two-level walk goes step by
//     step (where L1 is small nearly every group demotes). An eviction searches the pointer stream 32 words at a
//     time: each lane holds one word of the window the pointer is in, and
//     a ballot and a count of leading zeros give the victim without a
//     load; the next window loads while this one is searched.
//     The walker writes only death[victim] = t and lvl[demoted] = 2.
//  3. Warps 4-7 compute, behind the walker, the dirty flag each row is
//     born with, kTile rows at a time once the walker has passed them: a
//     row points at its parent in the tile, or is a terminal (a chain's
//     root, a row whose parent was cleaned, or one whose parent lies in
//     an earlier tile, whose flag is already written); pointer jumping in
//     shared memory (log2 of the longest in-tile chain rounds) gives each
//     row its terminal's flag. After the walk every thread clears the
//     cleaned tokens' flags and sums the flushes over the block.
//
// What bounds it on the card. The walk is serial, but only the resident
// count's update carries from one step to the next: one integer
// operation a step (IADD3 of the count, is_read and the sign of b - cand;
// b moves only at an eviction, so b - cand is off the chain), at the
// ALU's dependent-issue latency. Rows below l2_end need no step (the walk
// passes them as no-op words). The longest block's rows at or past l2_end
// times that one operation is the floor; the bytes (15 or 16 a row, read once and
// written once) at the memory rate are less. The previous design waited
// every step on a load of a word it had itself written (death[p]), about
// 175 ns; here every load the walk waits on is of read-only words staged
// in shared memory ahead of it. What the walk pays above the floor is its
// own instructions: the overflow compare and its branch after each step
// of a group that may overflow, and an eviction's search (a ballot, a
// count of leading zeros and the branches around them), which costs
// several steps. So blocks that evict or demote on most steps run several
// times slower than blocks that hit, and a single-level group of kU steps
// that cannot overflow is taken at once, its count chain alone.
// Defining RO_REPLAY_STEPWISE builds the single-level walk step by step,
// without that group path (benchmarks_torch/count_kernels.py times both).
//
// Contract. rd and force are bool (one byte) a row of the whole tape,
// prev and nxt int32 global positions: consistent links (nxt[prev[t]] ==
// t), severed at the tenant blocks, nxt clamped to the block end. desc
// holds, a block each, int64 (start, end, out) and the capacities: cap
// for the single level; cap1, cap2, l2_end (local), clean2 for two levels.
// death (int32, local positions), dirty (byte) and lvl (int8) are written
// at out + t for the block's rows; counts holds the flushes of block k at
// k and, for two levels, its demotions at K + k. Returns
// cudaGetLastError() after the launch (0 on success).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSingleDesc = 4;   // start, end, out, cap
constexpr int kLevelsDesc = 7;   // start, end, out, cap1, cap2, l2_end, clean2
constexpr int kLogR = 9;
constexpr int kR = 1 << kLogR;   // words a ring tile
constexpr int kStages = 4;       // tiles a ring (a power of two)
constexpr int kRing = kR * kStages;
constexpr int kU = 8;            // t-words the walker holds ahead
constexpr int kTile = 4096;      // rows a dirty-pass tile
constexpr int kNoOp = INT_MIN;   // a t-word of a write with nothing to hit

static_assert(kR % kU == 0 && kR >= 32, "ring tiles hold whole groups");

// ring control words in shared memory: full[s] tiles staged, freed[s]
// tiles no longer read, for s = 0 (t), 1 (b or b2), 2 (b1); done ends
// the producers
struct Control {
  int full[3];
  int freed[3];
  int done;
};

__device__ __forceinline__ int load_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ void store_volatile(int* p, int v) {
  *reinterpret_cast<volatile int*>(p) = v;
}

__device__ __forceinline__ void fence_cta() {
  asm volatile("fence.acq_rel.cta;" ::: "memory");
}

// the walker: wait until tile k of a ring is staged
__device__ __forceinline__ void wait_full(const int* full, int k) {
  while (load_volatile(full) <= k) {
  }
  fence_cta();
}

// the walker: tiles below k of a ring are no longer read
__device__ __forceinline__ void release(int* freed, int k) {
  fence_cta();
  store_volatile(freed, k);
}

// A producer warp: stage word(r) for ring indices r in [0, span + kR), a
// tile at a time (one tile past the span, for the walker's look-ahead),
// each once its slot is freed; stops early once the walk is done. A tile
// is kR / 32 words a lane, computed together (word() loads without
// branches), so that its loads are in flight at once: a tile costs a few
// memory latencies, far less than the walker's time on it.
template <class Word>
__device__ void produce(int* ring, Control* ctl, int s, int span,
                        Word word) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k * kR < span + kR; ++k) {
    int w[kR / 32];
#pragma unroll
    for (int i = 0; i < kR / 32; ++i) w[i] = word(k * kR + 32 * i + lane);
    while (load_volatile(&ctl->freed[s]) < k - kStages + 1) {
      if (load_volatile(&ctl->done)) return;
      __nanosleep(128);
    }
    fence_cta();
    int* slot = ring + (k & (kStages - 1)) * kR;
#pragma unroll
    for (int i = 0; i < kR / 32; ++i) slot[32 * i + lane] = w[i];
    __syncwarp();
    if (lane == 0) {
      fence_cta();
      store_volatile(&ctl->full[s], k + 1);
    }
  }
}

// A pointer stream as the walker warp sees it: a window of 32 words, the
// word at pos + 31 - lane in each lane, and the next window loading
// behind it. A victim search is one ballot (live, and at or past the
// pointer) and one count of leading zeros, with no load: the window moves
// on only once the pointer has passed its 32 words.
struct Stream {
  const int* ring;
  Control* ctl;
  int s;
  int first;      // the position at ring index 0
  int ready;      // ring indices below this are staged
  int freed;      // tiles released
  int limit;      // the last ring index a window may start at without
                  // staging or releasing a tile
  int pos;        // the window's first position
  int lp;         // this lane's position: pos + 31 - lane
  int win;        // this lane's word
  int ahead;      // this lane's word of the next window

  __device__ __forceinline__ void init(const int* ring_, Control* ctl_,
                                       int s_, int first_) {
    ring = ring_;
    ctl = ctl_;
    s = s_;
    first = first_;
    ready = 0;
    freed = 0;
    limit = -1;
    pos = first_;
    lp = first_ + 31 - (threadIdx.x & 31);
    win = fetch(0);
    ahead = fetch(32);
  }

  // this lane's word of the window at ring index r; tiles below r are
  // released (their words are in registers) and r's tiles waited for
  __device__ __forceinline__ int fetch(int r) {
    if (__builtin_expect(r > limit, 0)) {
      if ((r >> kLogR) > freed) {
        freed = r >> kLogR;
        release(&ctl->freed[s], freed);
      }
      if (r + 32 > ready) {
        const int k = (r + 31) >> kLogR;
        wait_full(&ctl->full[s], k);
        ready = (k + 1) << kLogR;
      }
      limit = min(ready - 32, ((freed + 1) << kLogR) - 1);
    }
    return ring[(r + 31 - (threadIdx.x & 31)) & (kRing - 1)];
  }

  // the first position at or past b whose word exceeds t: the oldest live
  // read token
  __device__ __forceinline__ int find(int t, int b) {
    unsigned live = __ballot_sync(0xffffffffu, win > t && lp >= b);
    while (__builtin_expect(live == 0, 0)) {   // the window is spent
      pos += 32;
      lp += 32;
      win = ahead;
      ahead = fetch(pos + 32 - first);
      live = __ballot_sync(0xffffffffu, win > t && lp >= b);
    }
    return pos + __clz(live);
  }
};

// The t stream as the walker sees it: groups of kU words, each loaded
// one group before it is walked.
struct TStream {
  const int* ring;
  Control* ctl;

  __device__ __forceinline__ void init(const int* ring_, Control* ctl_) {
    ring = ring_;
    ctl = ctl_;
    wait_full(&ctl->full[0], 0);
  }

  // the group at ring index r (a multiple of kU) into dst
  __device__ __forceinline__ void load(int (&dst)[kU], int r) {
    if ((r & (kR - 1)) == 0 && r > 0) {      // the first group of a tile
      release(&ctl->freed[0], r / kR);
      wait_full(&ctl->full[0], r / kR);
    }
    const int4* src = reinterpret_cast<const int4*>(ring + (r & (kRing - 1)));
#pragma unroll
    for (int i = 0; i < kU / 4; ++i) {
      const int4 v = src[i];
      dst[4 * i] = v.x;
      dst[4 * i + 1] = v.y;
      dst[4 * i + 2] = v.z;
      dst[4 * i + 3] = v.w;
    }
  }
};

// A global store the walker issues and never waits on.
__device__ __forceinline__ void store_int(int* p, int v) {
  asm volatile("st.global.s32 [%0], %1;" ::"l"(__cvta_generic_to_global(p)),
               "r"(v));
}

__device__ __forceinline__ void store_byte(int8_t* p, int v) {
  asm volatile("st.global.s8 [%0], %1;" ::"l"(__cvta_generic_to_global(p)),
               "r"(v));
}

// A step's change to the resident count of the level its previous
// occurrence may sit in: a read adds 1 unless it hits, a write takes 1
// away if it hits. With is_read (0 or 1) and cand (q) from the t-word,
// that is is_read - [q > b], and (b - q) >> 31 is -[q > b] (0 <= b, q <
// 2^31): two integer operations on the pointer and no branch.
__device__ __forceinline__ int step_delta(int rd, int q, int b) {
  return rd + ((b - q) >> 31);
}

// Warps 4-7 compute the dirty flag each row is born with while the walk
// runs, a tile of kTile rows once the walker has passed its end (a row's
// birth needs only its parent's token's fate: evicted, or demoted under a
// clean L2, both settled before the row's own step). A read hit is born
// with its parent's final flag (0 if the parent was cleaned, else the
// parent's birth flag), any other row with its forced flag; in a tile,
// each row points at its parent or is a terminal (a root, a cleaned
// parent, or a parent in an earlier tile), and pointer jumping in shared
// memory W (log2 of the longest in-tile chain rounds) gives each row its
// terminal's flag. The births are written to dirty.
constexpr int kTrailFirst = 128;   // the first thread of warps 4-7
constexpr int kTrail = kThreads - kTrailFirst;

__device__ __forceinline__ void trail_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kTrail) : "memory");
}

__device__ __forceinline__ int trail_any(int pred) {
  int any;
  asm volatile(
      "{ .reg .pred p, q;\n"
      "  setp.ne.s32 p, %1, 0;\n"
      "  bar.red.or.pred q, 1, %2, p;\n"
      "  selp.s32 %0, 1, 0, q; }"
      : "=r"(any)
      : "r"(pred), "n"(kTrail)
      : "memory");
  return any;
}

template <bool kLevels>
__device__ void birth_pass(int n, int base, int l2_end, bool clean2,
                           const uint8_t* __restrict__ rd,
                           const int* __restrict__ pv,
                           const uint8_t* __restrict__ force,
                           const int* death, const int8_t* lvl,
                           uint8_t* dirty, volatile int* W, Control* ctl) {
  const int tid = threadIdx.x - kTrailFirst;
  for (int a = 0; a < n; a += kTile) {
    const int m = min(kTile, n - a);
    if (tid == 0) {          // the walker has passed a + m: the t ring's
      while (!load_volatile(&ctl->done) &&   // tiles below freed are walked
             load_volatile(&ctl->freed[0]) * kR - kU < a + m) {
        __nanosleep(256);
      }
      fence_cta();
    }
    trail_sync();
#pragma unroll 4
    for (int i = tid; i < m; i += kTrail) {
      const int t = a + i;
      const int p = pv[t] - base;
      const bool hit = (!kLevels || t >= l2_end) && rd[t] && p >= 0 &&
                       rd[p] && death[p] == t;
      const bool cleaned =
          kLevels && clean2 && hit && p >= l2_end && lvl[p] == 2;
      W[i] = !hit      ? -1 - force[t]
             : cleaned ? -1
             : p < a   ? -1 - dirty[p]
                       : p - a;
    }
    trail_sync();
    for (;;) {                               // pointer jumping
      int more = 0;
      for (int i = tid; i < m; i += kTrail) {
        const int w = W[i];
        if (w >= 0) {
          const int up = W[w];
          W[i] = up;
          more |= up >= 0;
        }
      }
      if (!trail_any(more)) break;
    }
    for (int i = tid; i < m; i += kTrail) {
      dirty[a + i] = static_cast<uint8_t>(-1 - W[i]);
    }
    trail_sync();
  }
}

// After the walk, every thread: a token demoted under a clean L2 ends with
// 0 and flushed its birth flag then; every other victim (death < nxt)
// flushes the flag it ends with. Returns this thread's flushes.
template <bool kLevels>
__device__ long long finish_pass(int n, int base, int l2_end, bool clean2,
                                 const int* __restrict__ nx,
                                 const int* death, const int8_t* lvl,
                                 uint8_t* dirty) {
  long long flushes = 0;
#pragma unroll 4
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const int born = dirty[t];
    if (kLevels && clean2 && t >= l2_end && lvl[t] == 2) {
      flushes += born;
      dirty[t] = 0;
    } else if (death[t] != nx[t] - base) {
      flushes += born;
    }
  }
  return flushes;
}

__device__ long long block_sum(long long v, long long* part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  long long total = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += part[i];
  }
  return total;
}

template <bool kLevels>
__global__ void __launch_bounds__(kThreads, 2)
ro_replay_kernel(const uint8_t* __restrict__ rd_all,
                 const int* __restrict__ prev_all,
                 const int* __restrict__ nxt_all,
                 const uint8_t* __restrict__ force_all,
                 const long long* __restrict__ desc, int* death_all,
                 uint8_t* dirty_all, int8_t* lvl_all, long long* counts) {
  constexpr int kRings = kLevels ? 3 : 2;
  constexpr int kWords = kRings * kRing;
  __shared__ __align__(16) int smem[kWords];
  __shared__ int wtile[kTile];
  __shared__ Control ctl;
  __shared__ long long part[kWarps];

  const long long* d = desc + (kLevels ? kLevelsDesc : kSingleDesc) *
                                  static_cast<long long>(blockIdx.x);
  const long long s = d[0];
  const int n = static_cast<int>(d[1] - s);
  const int base = static_cast<int>(s);
  const int cap1 = static_cast<int>(d[3]);
  const int cap2 = kLevels ? static_cast<int>(d[4]) : 0;
  const int l2_end =
      kLevels ? static_cast<int>(min(max(d[5], 0LL), static_cast<long long>(n)))
              : 0;
  const bool clean2 = kLevels && d[6] != 0;
  const uint8_t* rd = rd_all + s;
  const int* pv = prev_all + s;
  const int* nx = nxt_all + s;
  const uint8_t* force = force_all + s;
  int* death = death_all + d[2];
  uint8_t* dirty = dirty_all + d[2];
  int8_t* lvl = kLevels ? lvl_all + d[2] : nullptr;

  if (n <= 0) {                                // an empty block
    if (threadIdx.x == 0) {
      counts[blockIdx.x] = 0;
      if (kLevels) counts[gridDim.x + blockIdx.x] = 0;
    }
    return;
  }

  // 1. lay out death and lvl
  if (threadIdx.x < 3) {
    ctl.full[threadIdx.x] = 0;
    ctl.freed[threadIdx.x] = 0;
  }
  if (threadIdx.x == 0) ctl.done = 0;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    death[t] = nx[t] - base;
    if (kLevels) lvl[t] = t < l2_end ? 2 : 1;
  }
  __syncthreads();

  // 2. the walk and its producers
  int* ring_t = smem;
  int* ring_b = smem + kRing;                  // b, or b2
  int* ring_b1 = kLevels ? smem + 2 * kRing : nullptr;
  const int warp = threadIdx.x >> 5;
  long long demotions = 0;
  // the producers' words; rows past the block are read at its last row
  // and their word replaced
  const int last = n - 1;
  if (warp == 1) {
    produce(ring_t, &ctl, 0, n, [=](int t) {
      const int tc = min(t, last);
      const int p = pv[tc] - base;
      const int cand = p >= 0 && rd[max(p, 0)] ? p + 1 : 0;
      const int w = (rd[tc] ? 0 : kNoOp) | cand;
      return t < l2_end || t >= n ? kNoOp : w;   // warm L2, or past the block
    });
  } else if (warp == 2) {
    produce(ring_b, &ctl, 1, n, [=](int j) {
      const int jc = min(j, last);
      const int w = rd[jc] ? nx[jc] - base : -1;
      return j < n ? w : INT_MAX;
    });
  } else if (kLevels && warp == 3) {
    produce(ring_b1, &ctl, 2, n - l2_end, [=](int r) {
      const int j = l2_end + r, jc = min(j, last);
      const int w = rd[jc] ? nx[jc] - base : -1;
      return j < n ? w : INT_MAX;
    });
  } else if (warp == 0) {
    // The walker warp: every lane walks (uniform control flow) so that a
    // ballot searches 32 pointer-stream words at once; lane 0 stores. A
    // capacity below 0 acts as 0 (the check follows an increment), so with
    // the caps clamped the count never exceeds its cap at a step's start
    // and one compare after the update finds each overflow.
    const int lane = threadIdx.x;
    TStream ts;
    ts.init(ring_t, &ctl);
    int wa[kU], wb[kU];                        // two groups, ping-pong
    ts.load(wa, 0);
    if (!kLevels) {
      const int cap = max(cap1, 0);
      Stream sb;
      sb.init(ring_b, &ctl, 1, 0);
      int res = 0, b = 0;
      // A group at once when it overflows nowhere (b fixed: the prefix
      // sums of its steps against the headroom), else step by step.
      auto group = [&](const int (&w)[kU], int t0) {
        int q[kU], r[kU], sum = 0, peak = 0;
#pragma unroll
        for (int i = 0; i < kU; ++i) {
          q[i] = w[i] & INT_MAX;
          r[i] = w[i] >= 0;
          sum += step_delta(r[i], q[i], b);
          peak = max(peak, sum);
        }
#ifndef RO_REPLAY_STEPWISE
        if (peak <= cap - res) {
          res += sum;
          return;
        }
#endif
#pragma unroll
        for (int i = 0; i < kU; ++i) {
          res += step_delta(r[i], q[i], b);    // install / invalidate
          if (res > cap) {                     // evict the oldest resident
            b = sb.find(t0 + i, b);
            if (lane == 0) store_int(death + b, t0 + i);
            ++b;
            --res;
          }
        }
      };
      for (int t0 = 0; t0 < n; t0 += 2 * kU) {
        ts.load(wb, t0 + kU);
        group(wa, t0);
        ts.load(wa, t0 + 2 * kU);
        group(wb, t0 + kU);
      }
    } else {
      const int c1 = max(cap1, 0), c2 = max(cap2, 0);
      Stream s2, s1;
      s2.init(ring_b, &ctl, 1, 0);
      s1.init(ring_b1, &ctl, 2, l2_end);
      int res1 = 0, res2 = l2_end, b1 = l2_end, b2 = 0;
      // Step by step: where L1 is small most groups demote, and trying a
      // group at once first costs more than it saves.
      auto group = [&](const int (&w)[kU], int t0) {
        int q[kU], r[kU];
#pragma unroll
        for (int i = 0; i < kU; ++i) {
          q[i] = w[i] & INT_MAX;
          r[i] = w[i] >= 0;
        }
#pragma unroll
        for (int i = 0; i < kU; ++i) {
          const int n1 = (b1 - q[i]) >> 31;    // -1: p's token is in L1
          const int n2 = (b2 - q[i]) >> 31;    // -1: ... or in L2 (kept)
          res1 += r[i] + n1;                   // install/rebirth, L1 write-hit
          res2 += n2 - n1;                     // L2 hit: promote or invalidate
          if (res1 > c1) {
            const int t = t0 + i;
            b1 = s1.find(t, b1);
            if (lane == 0) store_byte(lvl + b1, 2);  // demote L1's oldest
            ++b1;
            --res1;
            ++demotions;
            if (++res2 > c2) {
              b2 = s2.find(t, b2);
              if (lane == 0) store_int(death + b2, t);  // evicted for good
              ++b2;
              --res2;
            }
          }
        }
      };
      for (int t0 = 0; t0 < n; t0 += 2 * kU) {
        ts.load(wb, t0 + kU);
        group(wa, t0);
        ts.load(wa, t0 + 2 * kU);
        group(wb, t0 + kU);
      }
    }
    if (lane == 0) {
      fence_cta();
      store_volatile(&ctl.done, 1);
    }
  } else if (threadIdx.x >= kTrailFirst) {
    birth_pass<kLevels>(n, base, l2_end, clean2, rd, pv, force, death, lvl,
                        dirty, wtile, &ctl);
  }
  __syncthreads();

  // 3. the final dirty bits and the flushes
  const long long flushes = block_sum(
      finish_pass<kLevels>(n, base, l2_end, clean2, nx, death, lvl, dirty),
      part);
  if (threadIdx.x == 0) {
    counts[blockIdx.x] = flushes;
    if (kLevels) counts[gridDim.x + blockIdx.x] = demotions;
  }
}

}  // namespace

extern "C" int ro_token_replay_scan(const void* rd, const void* prev,
                                    const void* nxt, const void* force,
                                    const void* desc, void* death,
                                    void* dirty, void* counts, int blocks,
                                    void* stream) {
  if (blocks <= 0) return 0;
  ro_replay_kernel<false><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rd), static_cast<const int*>(prev),
      static_cast<const int*>(nxt), static_cast<const uint8_t*>(force),
      static_cast<const long long*>(desc), static_cast<int*>(death),
      static_cast<uint8_t*>(dirty), nullptr,
      static_cast<long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ro_token_replay_levels_scan(const void* rd, const void* prev,
                                           const void* nxt, const void* force,
                                           const void* desc, void* death,
                                           void* dirty, void* lvl,
                                           void* counts, int blocks,
                                           void* stream) {
  if (blocks <= 0) return 0;
  ro_replay_kernel<true><<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rd), static_cast<const int*>(prev),
      static_cast<const int*>(nxt), static_cast<const uint8_t*>(force),
      static_cast<const long long*>(desc), static_cast<int*>(death),
      static_cast<uint8_t*>(dirty), static_cast<int8_t*>(lvl),
      static_cast<long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
