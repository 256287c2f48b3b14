"""Synthetic block-trace generator calibrated to the paper's workloads.

A copy of ``repro.data.traces``: the draws run on numpy's generator
exactly as there, so the port replays bit-identical inputs; the
port's ``Trace`` takes the finished arrays as tensors.

The MSR-Cambridge traces (SNIA IOTTA) are not redistributable offline, so we
synthesize traces whose *published statistics* match the paper:

  * per-workload request-type mix — Fig. 12 (CR/CW/RAR/RAW/WAR/WAW ratios);
  * locality — Zipfian re-reference over a working set (random workloads) or
    streaming address ramps (sequential workloads);
  * run lengths — Table 2 relative runtimes.

The generator is constructive: it draws, per re-touch, the *target class*
(RAR/RAW/WAR/WAW) and picks a previously-read or previously-written address
accordingly, so the realized mix converges to the requested one.  Cold
accesses extend the working set.  This gives exact control over the very
quantities URD/Alg. 3 depend on.

Also included: Filebench-like profiles for the Fig. 4 motivation experiment
(fileserver, varmail, webserver, ... ) expressed as mix+locality parameters.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.trace import Trace

__all__ = ["WorkloadProfile", "MSR_PROFILES", "FILEBENCH_PROFILES",
           "generate_trace", "msr_trace", "filebench_trace",
           "sequential_then_random", "random_then_sequential",
           "semi_sequential", "synthetic_mix"]


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """Target statistics for one synthetic workload.

    cold_read/cold_write/rar/raw/war/waw: target fractions (sum ~ 1).
    zipf_a: Zipf exponent for re-reference locality (higher = tighter).
    working_set: approximate number of distinct blocks.
    sequential: if True, cold accesses stream (defeats caching, paper Fig. 9a).
    """

    cold_read: float
    cold_write: float
    rar: float
    raw: float
    war: float
    waw: float
    zipf_a: float = 1.2
    working_set: int = 4096
    sequential: bool = False
    # Re-touch depth exponents: rank ~ u**a over most-recent-first pools.
    # Large a -> shallow (recent) re-touches; small a -> deep re-touches.
    # The paper's Eq. 1 case-2 workloads (TRD >> URD) arise when write
    # re-touches are much deeper than read re-touches: a slowly-cycled large
    # write set inflates TRD while the hot read set keeps URD small.
    read_depth_a: float | None = None    # default: zipf_a
    write_depth_a: float = 0.35
    # Hard bound on how deep read re-touches reach into the access pool:
    # bounds URD (and the useful cache size) structurally, while write
    # re-touches range over the whole pool (inflating TRD).  None = unbounded
    # (Eq. 1 case 1: TRD == URD).
    read_reach: int | None = 256

    def normalized(self) -> "WorkloadProfile":
        s = (self.cold_read + self.cold_write + self.rar + self.raw
             + self.war + self.waw)
        return dataclasses.replace(
            self, cold_read=self.cold_read / s, cold_write=self.cold_write / s,
            rar=self.rar / s, raw=self.raw / s, war=self.war / s,
            waw=self.waw / s)


# Request-type mixes approximating paper Fig. 12 (per-workload descriptions in
# §6.4/§6.6: e.g. wdev_0 ~77% WAW + mostly-RAR rest; hm_1 >92% RAR;
# prxy_0/web_0 WAW/WAR-heavy; stg_1/mds_1/prn_1 RAR/RAW-dominant, etc.).
# ``read_reach`` / cold rates are tuned so the TRD/URD size ratios land where
# the paper reports them (stg_1 Centaur ~1000x ECI, rsrch_2 extreme,
# mds_0/proj_0 sizes occasionally equal — App. A).
MSR_PROFILES: dict[str, WorkloadProfile] = {
    "wdev_0":  WorkloadProfile(0.04, 0.12, 0.12, 0.02, 0.00, 0.70,
                               read_reach=128),
    "web_1":   WorkloadProfile(0.10, 0.12, 0.20, 0.05, 0.04, 0.49,
                               read_reach=192),
    "stg_1":   WorkloadProfile(0.06, 0.34, 0.08, 0.06, 0.06, 0.40,
                               working_set=1 << 17, read_reach=96),
    "ts_0":    WorkloadProfile(0.05, 0.15, 0.10, 0.02, 0.05, 0.63,
                               read_reach=160),
    "hm_1":    WorkloadProfile(0.05, 0.03, 0.88, 0.02, 0.00, 0.02,
                               read_reach=384),
    "mds_0":   WorkloadProfile(0.04, 0.12, 0.08, 0.03, 0.05, 0.68,
                               read_reach=256, write_depth_a=0.9),
    "proj_0":  WorkloadProfile(0.03, 0.26, 0.08, 0.03, 0.06, 0.54,
                               read_reach=256, write_depth_a=0.9),
    "prxy_0":  WorkloadProfile(0.02, 0.10, 0.06, 0.04, 0.08, 0.70,
                               read_reach=96),
    "rsrch_0": WorkloadProfile(0.02, 0.12, 0.05, 0.03, 0.09, 0.69,
                               read_reach=96),
    "src1_2":  WorkloadProfile(0.02, 0.12, 0.05, 0.02, 0.10, 0.69,
                               read_reach=96),
    "prn_1":   WorkloadProfile(0.08, 0.12, 0.38, 0.22, 0.05, 0.15,
                               working_set=1 << 16, read_reach=512),
    "src2_0":  WorkloadProfile(0.03, 0.12, 0.06, 0.03, 0.07, 0.69,
                               read_reach=96),
    "web_0":   WorkloadProfile(0.03, 0.10, 0.08, 0.04, 0.10, 0.65,
                               read_reach=128),
    "usr_0":   WorkloadProfile(0.10, 0.15, 0.33, 0.17, 0.08, 0.17,
                               working_set=1 << 16, read_reach=384),
    "rsrch_2": WorkloadProfile(0.02, 0.38, 0.005, 0.005, 0.15, 0.44,
                               sequential=True, read_reach=32),
    "mds_1":   WorkloadProfile(0.06, 0.10, 0.43, 0.25, 0.06, 0.10,
                               working_set=1 << 15, read_reach=320),
}

# Paper Table 2 run-times (minutes) -> relative trace lengths.
MSR_RUNTIME_MIN: dict[str, int] = {
    "wdev_0": 1140, "web_1": 160, "stg_1": 2190, "ts_0": 1800, "hm_1": 600,
    "mds_0": 1210, "proj_0": 4220, "prxy_0": 12510, "rsrch_0": 1430,
    "src1_2": 1900, "prn_1": 11230, "src2_0": 1550, "web_0": 2020,
    "usr_0": 2230, "rsrch_2": 200, "mds_1": 1630,
}

# Fig. 4 Filebench personalities (read/write mixes per Filebench docs; the
# observations in §3 drive the expected WB-vs-RO outcomes).
FILEBENCH_PROFILES: dict[str, WorkloadProfile] = {
    "fileserver":       WorkloadProfile(0.10, 0.15, 0.25, 0.20, 0.10, 0.20),
    "randomrw":         WorkloadProfile(0.05, 0.05, 0.25, 0.25, 0.20, 0.20),
    "varmail":          WorkloadProfile(0.08, 0.12, 0.25, 0.30, 0.10, 0.15),
    "webserver":        WorkloadProfile(0.10, 0.02, 0.76, 0.02, 0.02, 0.08),
    "copyfiles":        WorkloadProfile(0.45, 0.45, 0.02, 0.02, 0.03, 0.03,
                                        sequential=True),
    "webproxy":         WorkloadProfile(0.12, 0.03, 0.72, 0.03, 0.02, 0.08),
    "mongo":            WorkloadProfile(0.25, 0.15, 0.30, 0.10, 0.05, 0.15,
                                        sequential=True),
    "singlestreamread": WorkloadProfile(0.30, 0.02, 0.60, 0.04, 0.02, 0.02,
                                        working_set=1024),
}


def generate_trace(profile: WorkloadProfile, n: int, seed: int = 0,
                   name: str = "") -> Trace:
    """Draw an n-access trace matching ``profile``'s target class mix."""
    p = profile.normalized()
    rng = np.random.default_rng(seed)
    addrs = np.empty(n, dtype=np.int64)
    is_read = np.empty(n, dtype=bool)

    read_pool: list[int] = []     # addresses whose last touch was a read
    write_pool: list[int] = []    # addresses whose last touch was a write
    next_cold = 0                 # streaming frontier for cold addresses

    classes = rng.choice(6, size=n, p=[p.cold_read, p.cold_write, p.rar,
                                       p.raw, p.war, p.waw])
    # Zipf ranks for picking *which* previously-touched address to re-use.
    zipf_u = rng.random(n)

    read_a = p.read_depth_a if p.read_depth_a is not None else p.zipf_a

    def pick(pool: list[int], u: float, a: float, reach: int | None) -> int:
        # Zipf-like: rank ~ u**a over most-recent-first ordering, optionally
        # truncated to the most recent ``reach`` entries.
        k = len(pool)
        if reach is not None:
            k = min(k, reach)
        r = int((u ** a) * k)
        return pool[len(pool) - 1 - min(r, k - 1)]

    for i in range(n):
        c = int(classes[i])
        if c >= 2:
            src_read = c in (2, 4)       # RAR/WAR re-touch a last-read addr
            pool = read_pool if src_read else write_pool
            if not pool:                 # nothing to re-touch yet -> cold
                c = 0 if c in (2, 3) else 1
        if c == 0 or c == 1:
            a = next_cold if p.sequential else int(rng.integers(0, 2**31))
            next_cold += 1
            rd = c == 0
        else:
            src_read = c in (2, 4)
            pool = read_pool if src_read else write_pool
            # current access type decides the depth: reads (RAR/RAW) re-touch
            # recent data, writes (WAR/WAW) cycle deep through their set.
            if c in (2, 3):
                a = pick(pool, float(zipf_u[i]), read_a, p.read_reach)
            else:
                a = pick(pool, float(zipf_u[i]), p.write_depth_a, None)
            rd = c in (2, 3)
        addrs[i] = a
        is_read[i] = rd
        # update pools: address moves to the pool of its current access type
        if rd:
            read_pool.append(a)
            if len(read_pool) > p.working_set:
                read_pool.pop(0)
        else:
            write_pool.append(a)
            if len(write_pool) > p.working_set:
                write_pool.pop(0)
    return Trace(addrs, is_read, name)


def msr_trace(name: str, n: int = 20000, seed: int = 0) -> Trace:
    return generate_trace(MSR_PROFILES[name], n, seed, name)


def filebench_trace(name: str, n: int = 20000, seed: int = 0) -> Trace:
    return generate_trace(FILEBENCH_PROFILES[name], n, seed, name)


# ---------------------------------------------------------------- Appendix C
def sequential_then_random(n_seq: int, n_rand: int, seed: int = 0) -> Trace:
    """Paper App. C case 1: streaming interval then random repeats."""
    rng = np.random.default_rng(seed)
    seq = np.arange(n_seq, dtype=np.int64)
    rand = rng.choice(seq, size=n_rand, replace=True)
    addrs = np.concatenate([seq, rand])
    return Trace(addrs, np.ones(len(addrs), bool), "seq-rand")


def random_then_sequential(n_rand: int, n_seq: int, ws: int = 64,
                           seed: int = 0) -> Trace:
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, ws, size=n_rand).astype(np.int64)
    seq = np.arange(10**6, 10**6 + n_seq, dtype=np.int64)
    addrs = np.concatenate([rand, seq, rand])
    reads = np.concatenate([np.ones(n_rand, bool), np.zeros(n_seq, bool),
                            np.ones(n_rand, bool)])
    return Trace(addrs, reads, "rand-seq")


def semi_sequential(stride: int, repeats: int, seed: int = 0) -> Trace:
    base = np.arange(stride, dtype=np.int64)
    addrs = np.tile(base, repeats)
    return Trace(addrs, np.ones(len(addrs), bool), "semi-seq")


def synthetic_mix(n_tenants: int, n: int, seed: int = 0) -> list[Trace]:
    """Fast vectorized zipf-ish mixes for control-plane scale runs: the
    draws of ``benchmarks/bench_monitor_scale.py``'s ``synthetic_mix``,
    in the same order (trace realism is irrelevant to the control
    plane's cost; the Table-3 workloads use the MSR profiles)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_tenants):
        ws = int(rng.integers(300, 3000))
        u = rng.random(n)
        addrs = np.minimum((u ** 2.2) * ws, ws - 1).astype(np.int64)
        is_read = rng.random(n) < float(rng.uniform(0.4, 0.9))
        out.append(Trace(addrs, is_read, f"mix{i}"))
    return out
