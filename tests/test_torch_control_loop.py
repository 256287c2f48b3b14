"""The port's Δt control loop, as a whole, against the JAX reference.

* The fig10/12/14/16 sections of ``tests/goldens/figs_small.json`` are
  rebuilt from ``repro_torch`` on ``device="cpu"`` and compared with the
  file: integers, policies and floats all exactly (the port repeats the
  reference's float64 arithmetic; no field needs a tolerance).
* A live differential runs ``ECICacheManager.run_window`` of both
  packages over several seeds at capacities where every window is
  infeasible (so ``pgd_solve`` runs) and write-heavy tenants go RO under
  eviction pressure (so the eviction-token replay runs): sizes, policies,
  feasibility, per-tenant counts and latencies, and final LRU states are
  equal; the aggregate partition latency (a float64 sum over tenants
  whose order differs from numpy's) to rel 1e-12.
* A subprocess imports the port with ``jax`` and ``repro`` blocked.
"""
import json
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.core.batch_sim as ref_batch_sim
import repro_torch.core.batch_sim as pt_batch_sim
from repro.core import make_manager as make_manager_ref
from repro.data.traces import msr_trace as msr_trace_ref
from repro_torch.core import (make_manager, request_type_mix, write_ratio)
from repro_torch.core.write_policy import assign_write_policy
from repro_torch.data.traces import msr_trace

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN_PATH = REPO / "tests" / "goldens" / "figs_small.json"
NAMES = ["wdev_0", "hm_1", "prn_1", "web_0", "prxy_0", "ts_0"]
SIM = dict(t_fast=1.0, t_slow=20.0, flush_cost=10.0)


# ------------------------------------------------------------- goldens
def _run_scheme(scheme, capacity, windows=2, n=400):
    mgr = make_manager(scheme, capacity, NAMES, c_min=10, initial_blocks=20,
                       engine="batch", device="cpu", **SIM)
    for w in range(windows):
        mgr.run_window([msr_trace(nm, n, seed=1000 * w + i)
                        for i, nm in enumerate(NAMES)])
    return mgr


def _fig10():
    out = {}
    for scheme in ("eci", "centaur"):
        mgr = _run_scheme(scheme, 900)
        out[scheme] = {
            "infeasible_windows": sum(not d.feasible for d in mgr.history),
            "allocs": [int(d.sizes.sum()) for d in mgr.history],
            "final_sizes": [int(s) for s in mgr.history[-1].sizes],
        }
    return out


def _fig12():
    mixes, policies = {}, {}
    for nm in NAMES:
        t = msr_trace(nm, 600, seed=12)
        mixes[nm] = {k: float(v) for k, v in request_type_mix(t).items()}
        policies[nm] = [
            assign_write_policy(msr_trace(nm, 300, seed=100 + w), 0.5).value
            for w in range(3)]
    sweep = {str(thr): sum(assign_write_policy(
        msr_trace(nm, 300, seed=7), thr).value == "ro" for nm in NAMES)
        for thr in (0.2, 0.5, 0.8)}
    wr = {nm: float(write_ratio(msr_trace(nm, 600, seed=12)))
          for nm in NAMES}
    return {"mixes": mixes, "policies": policies, "sweep": sweep,
            "write_ratios": wr}


def _fig14():
    out = {}
    for scheme in ("eci", "centaur"):
        mgr = _run_scheme(scheme, 800)
        s = mgr.summary()
        out[scheme] = {
            "performance": float(s["performance"]),
            "perf_per_cost": float(s["perf_per_cost"]),
            "mean_latency": float(s["mean_latency"]),
            "tenant_latencies": [float(t.result.total_latency)
                                 for t in mgr.tenants],
        }
    return out


def _fig16():
    out = {}
    for scheme in ("eci", "centaur"):
        mgr = _run_scheme(scheme, 900)
        out[scheme] = {
            "cache_writes": [int(t.result.cache_writes)
                             for t in mgr.tenants],
            "total": int(mgr.summary()["cache_writes"]),
            "policies": [t.policy.value for t in mgr.tenants],
        }
    return out


@pytest.mark.parametrize("fig,build", [("fig10", _fig10), ("fig12", _fig12),
                                       ("fig14", _fig14), ("fig16", _fig16)])
def test_port_reproduces_goldens(fig, build):
    want = json.loads(GOLDEN_PATH.read_text())[fig]
    got = json.loads(json.dumps(build()))          # normalize types
    assert got == want


# ------------------------------------------------- live differential
@pytest.fixture
def token_replays(monkeypatch):
    """Counts the port's eviction-token replays (RO under pressure)."""
    calls = []
    orig = pt_batch_sim._ro_token_replay

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(pt_batch_sim, "_ro_token_replay", counted)
    return calls


def _assert_same_window(a, b):
    da, db = a.history[-1], b.history[-1]
    assert da.sizes.tolist() == db.sizes.tolist()
    assert [p.value for p in da.policies] == [p.value for p in db.policies]
    assert da.feasible == db.feasible
    assert da.guard == db.guard
    assert db.partition.latency == pytest.approx(da.partition.latency,
                                                 rel=1e-12)
    for ta, tb in zip(a.tenants, b.tenants):
        ra, rb = ta.result, tb.result
        for f in ("reads", "read_hits", "writes", "write_hits",
                  "cache_writes", "total_latency", "capacity", "policy"):
            assert getattr(ra, f) == getattr(rb, f), f
        xa, fa = ta.cache.state_arrays()
        xb, fb = tb.cache.state_arrays()
        np.testing.assert_array_equal(np.asarray(xa), xb.numpy())
        np.testing.assert_array_equal(np.asarray(fa), fb.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scheme,capacity", [("eci", 300), ("centaur", 500)])
def test_run_window_matches_reference(seed, scheme, capacity, token_replays):
    names = NAMES + ["stg_1", "usr_0"]
    kw = dict(c_min=10, initial_blocks=40, engine="batch", **SIM)
    a = make_manager_ref(scheme, capacity, names, **kw)
    b = make_manager(scheme, capacity, names, device="cpu", **kw)
    for w in range(3):
        seeds = [100 * seed + 10 * w + i for i in range(len(names))]
        a.run_window([msr_trace_ref(nm, 1500, seed=s)
                      for nm, s in zip(names, seeds)])
        b.run_window([msr_trace(nm, 1500, seed=s)
                      for nm, s in zip(names, seeds)])
        _assert_same_window(a, b)
    assert not any(d.feasible for d in b.history)     # pgd ran every window
    if scheme == "eci":
        assert token_replays                         # RO under pressure ran
    sa, sb = a.summary(), b.summary()
    assert sb == pytest.approx({k: sa[k] for k in sb}, rel=1e-12)


@pytest.mark.parametrize("seed", [3, 4])
def test_simulate_many_matches_reference(seed, token_replays):
    """Mixed WB/WT/RO tenants over warm caches, with window RDs."""
    rng = np.random.default_rng(seed)
    names = ["wdev_0", "hm_1", "prxy_0", "usr_0", "web_0"]
    pols = [ref_batch_sim.WritePolicy(p) for p in
            rng.choice(["wb", "wt", "ro"], len(names))]
    pols[0] = ref_batch_sim.WritePolicy.RO
    caps = rng.integers(8, 60, len(names)).tolist()
    from repro.core.simulator import LRUCache as LRURef
    from repro_torch.core.simulator import LRUCache
    from repro_torch.core.write_policy import WritePolicy
    ca = [LRURef(c) for c in caps]
    cb = [LRUCache(c) for c in caps]
    for w in range(2):
        tr = [msr_trace_ref(nm, 800, seed=50 * seed + 5 * w + i)
              for i, nm in enumerate(names)]
        ra, rda = ref_batch_sim.simulate_many(
            tr, policies=pols, caches=ca, flush_cost=7.0,
            return_window_rd=True)
        rb, rdb = pt_batch_sim.simulate_many(
            [msr_trace(nm, 800, seed=50 * seed + 5 * w + i)
             for i, nm in enumerate(names)],
            policies=[WritePolicy(p.value) for p in pols], caches=cb,
            flush_cost=7.0, return_window_rd=True, device="cpu")
        for x, y in zip(ra, rb):
            for f in ("reads", "read_hits", "writes", "write_hits",
                      "cache_writes", "total_latency", "capacity", "policy"):
                assert getattr(x, f) == getattr(y, f), f
        for x, y in zip(rda, rdb):
            np.testing.assert_array_equal(x, y.numpy())
        for x, y in zip(ca, cb):
            np.testing.assert_array_equal(np.asarray(x.state_arrays()[0]),
                                          y.state_arrays()[0].numpy())
            np.testing.assert_array_equal(np.asarray(x.state_arrays()[1]),
                                          y.state_arrays()[1].numpy())
    assert token_replays


def test_simulate_many_without_window_rd():
    tr = [msr_trace(nm, 300, seed=i) for i, nm in enumerate(NAMES)]
    res = pt_batch_sim.simulate_many(tr, capacities=[0, 30, 30, 0, 30, 30],
                                     return_window_rd=False, device="cpu")
    ref = ref_batch_sim.simulate_many(
        [msr_trace_ref(nm, 300, seed=i) for i, nm in enumerate(NAMES)],
        capacities=[0, 30, 30, 0, 30, 30])
    assert [r.read_hits for r in res] == [r.read_hits for r in ref]
    assert [r.total_latency for r in res] == [r.total_latency for r in ref]


# ------------------------------------------------ import isolation
def test_port_imports_without_jax_and_defaults_to_the_card():
    """``repro_torch`` imports with ``jax``, ``triton`` and ``repro``
    blocked, and an entry point without ``device`` asks for the card:
    with none visible it raises naming ``device='cpu'``."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["triton"] = None
        sys.modules["repro"] = None
        import torch
        import repro_torch.core, repro_torch.kernels.cache_sim.ops
        import repro_torch.data.traces
        from repro_torch.core import make_manager
        if torch.cuda.is_available():
            print("card", make_manager("eci", 10, ["a"]).device)
        else:
            try:
                make_manager("eci", 10, ["a"])
            except RuntimeError as e:
                print("raised", e)
    """)
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True).stdout
    if torch.cuda.is_available():
        assert out.startswith("card cuda")
    else:
        assert out.startswith("raised") and "device='cpu'" in out


def test_port_sources_name_no_jax_or_reference_package():
    bad = []
    for p in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        for k, line in enumerate(p.read_text().splitlines(), 1):
            s = line.strip()
            if s.startswith(("import ", "from ")) and (
                    "jax" in s or "triton" in s
                    or s.split()[1].split(".")[0] == "repro"):
                bad.append(f"{p.name}:{k}: {s}")
    assert not bad, bad
