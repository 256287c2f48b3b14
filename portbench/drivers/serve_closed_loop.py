"""Driver of the serving cells: the port's ECI-managed paged KV server
under a closed loop of clients.

The deployment is the configuration file's: a ``BlockPool``, an
``ECICacheManager`` over its tenants, a ``TieredKVCache`` and a
``MultiTenantEngine``, as ``chip_smoke.py``'s ``serve_engine`` builds
them.  The engine and the tiered cache are subclassed here only to time
``super()``'s methods (host spans, and annotations in the device trace)
and to keep what the correctness check needs: every token's host stamp
(taken after ``_prefill_one`` or ``_decode_batch``, each of which ends
in a host read of the sampled token), and each request's pages as they
were when it took them.

Set-up: every client sends a request, and the loop runs until each has
had one answered and the manager has rebalanced ``setup_rebalances``
times.  The window then runs the same loop for ``seconds``: a client
whose request completes sends its next at once.  A traced run adds a
tail of ``TRACE_SECONDS`` under the profiler after the window, which is
untraced as in any run.  After the window, the
pool and the engine are freed and a sample of the requests that finished
(drawn from the seed, the longest among them) is scored by the fp32
reference: the widest gap by which a served token's logit lies below the
reference's best at its position.  What depends on the model's
architecture (its port configuration, weights, pool layout, kernels'
bounds and FLOPs) comes from the configuration's family module, and the
scoring from the family's reference (``portbench/families/``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from portbench import trace as tr
from portbench import traffic as tf
from repro_torch.cache import BlockPool, TieredKVCache
from repro_torch.core import ECICacheManager
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import MultiTenantEngine, Request

__all__ = ["Record", "ServeRun", "run"]

# set-up steps after which a loop that answers no client is a fault
SETUP_STEP_LIMIT = 20000
# seconds of the traced tail that follows the window in a traced run
TRACE_SECONDS = 10.0


@dataclasses.dataclass
class Record:
    """One request as the harness saw it."""
    client: int
    submit: float
    tenant: str
    req: Request
    stamps: list = dataclasses.field(default_factory=list)
    metas: list = dataclasses.field(default_factory=list)
    done_at: float | None = None
    lost: int = 0                 # pages that changed owner while in use


class _Spans:
    """Host spans on the wall clock (ns), kept in a traced run to name the
    device's idle gaps."""

    def __init__(self, on: bool):
        self.on, self.by_name = on, {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        a = time.time_ns()
        try:
            yield
        finally:
            self.by_name.setdefault(name, []).append((a, time.time_ns()))


class _TimedTiered(TieredKVCache):
    def __init__(self, *a, spans: _Spans, **k):
        super().__init__(*a, **k)
        self.span, self.rebalances = spans, 0

    def rebalance(self) -> None:
        if self._n_ev == 0:
            return
        with self.span("rebalance"):
            super().rebalance()
        self.rebalances += 1


def _take(pins: list, at: int, pid: int) -> tuple:
    """The page's owner when the engine pinned it (None when it pinned a
    page already freed, or took page 0 without one), and the next pin."""
    if at < len(pins) and pins[at][0] == pid:
        return pins[at][1], at + 1
    return None, at


class _TimedEngine(MultiTenantEngine):
    """The port's engine, its calls timed from outside; in a traced run,
    the family's least time of each kernel a call runs, summed by kernel
    in ``bound_s``."""

    def __init__(self, *a, spans: _Spans, family, file: dict, **k):
        super().__init__(*a, **k)
        self.span, self.family, self.file = spans, family, file
        self.records: dict[int, Record] = {}
        self.prefills: list = []     # (start, end, prompt tokens)
        self.decodes: list = []      # (start, end, lengths before)
        self.bound_s: dict[str, float] = {}
        self.fallbacks = 0
        self._seen_done = 0
        self._pins: list = []
        alloc, pin = self.pool.allocate, self.pool.pin

        def allocate(tenant, *a, **k):        # an unmanaged page refused:
            pid, evicted = alloc(tenant, *a, **k)   # the engine falls back
            self.fallbacks += tenant == -2 and pid is None      # to page 0
            return pid, evicted

        def pinned(pid):                      # who owns the page as the
            self._pins.append((pid, self.pool.meta.get(pid)))   # engine
            pin(pid)                                            # takes it
        self.pool.allocate, self.pool.pin = allocate, pinned

    def _add_bounds(self, bounds: dict) -> None:
        for kernel, s in bounds.items():
            self.bound_s[kernel] = self.bound_s.get(kernel, 0.0) + s

    def _prefill_one(self, req: Request) -> None:
        self._pins = []
        t = time.perf_counter()
        with self.span("prefill"):
            super()._prefill_one(req)
        e = time.perf_counter()
        rec = self.records[req.rid]
        rec.stamps.append(e)
        at = 0
        for p in req.pages:
            m, at = _take(self._pins, at, p)
            rec.metas.append(m)
        s = len(req.prompt)
        self.prefills.append((t, e, s))
        if self.span.on:
            padded = -(-s // self.page) * self.page
            self._add_bounds(self.family.prefill_bound_s(self.file, padded))

    def _decode_batch(self) -> None:
        reqs = [r for r in self.active if not r.done]
        lens = [r.length for r in reqs]
        if self.span.on and reqs:
            self._add_bounds(self.family.decode_bound_s(
                self.file, [np.asarray(r.pages) for r in reqs],
                np.asarray(lens), self.page, self.max_pages))
        self._pins = []
        t = time.perf_counter()
        with self.span("decode"):
            super()._decode_batch()
        e = time.perf_counter()
        if reqs:
            self.decodes.append((t, e, lens))
        at = 0
        for r in reqs:
            rec = self.records[r.rid]
            rec.stamps.append(e)
            for p in r.pages[len(rec.metas):]:
                m, at = _take(self._pins, at, p)
                rec.metas.append(m)
            if r.done:
                rec.done_at = e
                rec.lost = sum(m is None or self.pool.meta.get(p) is not m
                               for p, m in zip(r.pages, rec.metas))

    def pop_done(self) -> list[Record]:
        out = [self.records[r.rid] for r in self.completed[self._seen_done:]]
        self._seen_done = len(self.completed)
        return out


def _build(cfg: dict, family, mcfg: ModelConfig, params: dict,
           dev: torch.device) -> _TimedEngine:
    dep = cfg["deployment"]
    pool = BlockPool(dep["pool_pages"], dep["page_tokens"],
                     *family.pool_layout(cfg),
                     dtype=getattr(torch, mcfg.dtype), device=dev)
    mgr = ECICacheManager(dep["manager_capacity"], list(dep["tenants"]),
                          c_min=dep["c_min"],
                          initial_blocks=dep["initial_blocks"], device=dev)
    spans = _Spans(False)
    tiered = _TimedTiered(pool, mgr, window_events=dep["window_events"],
                          spans=spans)
    return _TimedEngine(mcfg, params, tiered, page_size=dep["page_tokens"],
                        max_pages_per_seq=dep["max_pages_per_seq"],
                        spans=spans, family=family, file=cfg,
                        **family.engine_kwargs(cfg))


@dataclasses.dataclass
class ServeRun:
    """What a serving run leaves for the metric readers and the check."""
    cfg: dict
    seconds: float
    setup_s: float
    t0: float
    t_end: float
    t_close: float
    records: list
    prefills: list
    decodes: list
    rebalance_s: float           # the tiered cache's counter, in window
    rebalances: int
    bound_s: dict
    trace: dict | None
    attempted: int
    failed: int
    compared: dict
    device: dict
    notes: dict
    family: object = None        # the configuration's family module

    # ------------------------------------------------ what the readers use
    def in_window(self, t: float) -> bool:
        return self.t0 <= t <= self.t_end

    def window_tokens(self) -> int:
        return sum(self.in_window(s) for r in self.records for s in r.stamps)


def _gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each of ``tokens``' logits lies below the best of the
    reference's logits ``ref`` [positions, vocab] at its position."""
    return ref.max(-1).values - ref.gather(1, tokens[:, None])[:, 0]


def _widest_and_mean(gaps: list[torch.Tensor]) -> dict:
    g = torch.cat(gaps)
    return {"logit_gap": float(g.max()), "logit_gap_mean": float(g.mean())}


def _check(params, cfg, reference, sample, page, limits, fallbacks, lost,
           control: bool) -> tuple:
    """The numbers compared (those named in the cell's limits, each
    beside its limit), the MoE choices the reference dropped, the
    program's readings, and with ``control`` the fp8 reference's readings
    on the same sample (and, beside them, the bf16-rounded reference's)."""
    served = [(r.req.prompt, r.req.generated) for r in sample]
    logits, drops = reference.served_logits(params, cfg, served, page)
    gaps = [_gaps(lg, torch.as_tensor(r.req.generated, device=lg.device))
            for lg, r in zip(logits, sample)]
    readings = _widest_and_mean(gaps)
    if control:      # the fp8 reference in the program's place, and bf16
        control = {}
        for prec in ("fp8", "bf16"):
            low, _ = reference.served_logits(params, cfg, served, page,
                                             precision=prec)
            control[prec] = _widest_and_mean(
                [_gaps(lg, lo.argmax(-1)) for lg, lo in zip(logits, low)])
    print("portbench: checked (rid, tenant, prompt, served, lost pages, "
          "widest gap): " + ", ".join(
              f"({r.req.rid}, {r.tenant}, {len(r.req.prompt)}, "
              f"{len(r.req.generated)}, {r.lost}, {float(g.max()):.4g})"
              for r, g in zip(sample, gaps)), file=sys.stderr)
    print(f"portbench: readings {readings}", file=sys.stderr)
    compared = {k: [readings[k], lim] for k, lim in limits.items()}
    compared.update(lost_pages=[lost, 0], fallback_pages=[fallbacks, 0])
    return compared, drops, readings, control


def run(cfg: dict, mix: dict, *, seed: int, seconds: float, trace: bool,
        device: str, t_start: float, limits: dict, family, reference,
        fault=None, control: bool = False) -> ServeRun:
    """One run of a serving cell of the configuration ``cfg``, built by
    the module ``family`` and scored by the module ``reference``.
    ``fault``, for the tests only, is called with the engine before the
    traffic starts and may break it; with ``control`` the notes also hold
    ``control``: the widest and the mean gap of the tokens the fp8
    reference puts first on the same sample."""
    dev = torch.device(device)
    mcfg = family.model_config(cfg)
    params = family.make_params(cfg, seed, dev)
    eng = _build(cfg, family, mcfg, params, dev)
    if fault is not None:
        fault(eng)
    traffic = tf.Traffic(mix, seed, cfg["vocab_size"])
    tenant_ids = {n: i for i, n in enumerate(cfg["deployment"]["tenants"])}

    def submit(client: int) -> None:
        spec, prompt, out = traffic.next()
        req = Request(tenant=tenant_ids[spec.tenant], prompt=prompt,
                      max_new_tokens=out)
        eng.submit(req)
        eng.records[req.rid] = Record(client, time.perf_counter(),
                                      spec.tenant, req)

    n_clients = int(mix["clients"])
    for c in range(n_clients):
        submit(c)
    answered: set[int] = set()
    steps = 0
    while (len(answered) < n_clients
           or eng.tiered.rebalances < mix["setup_rebalances"]):
        eng.step()
        for rec in eng.pop_done():
            answered.add(rec.client)
            submit(rec.client)
        steps += 1
        if steps > SETUP_STEP_LIMIT:
            raise RuntimeError(f"set-up answered {len(answered)} of "
                               f"{n_clients} clients in {steps} steps")

    def serve(until: float) -> list[Record]:
        """Steps until ``until``; the last step's completions are returned
        unanswered."""
        while True:
            eng.step()
            done = eng.pop_done()
            if time.perf_counter() >= until:
                return done
            with eng.span("client"):
                for rec in done:
                    submit(rec.client)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    rb_s0, rb0 = eng.tiered.rebalance_seconds, eng.tiered.rebalances
    fb0 = eng.fallbacks
    stats0 = dict(eng.pool.stats), eng.tiered.summary()
    eng.prefills, eng.decodes = [], []
    first_rid = eng._rid
    t_end = t0 + seconds
    pending = serve(t_end)
    t_close = time.perf_counter()
    attempted = eng._rid - first_rid
    rebalance_s = eng.tiered.rebalance_seconds - rb_s0
    rebalances = eng.tiered.rebalances - rb0
    fallbacks = eng.fallbacks - fb0
    stats1, tier1 = dict(eng.pool.stats), eng.tiered.summary()
    notes = {
        "pool": {k: stats1[k] - stats0[0][k] for k in stats1},
        "hbm_writes": tier1["hbm_writes"] - stats0[1]["hbm_writes"],
        "bypassed_writes": (tier1["bypassed_writes"]
                            - stats0[1]["bypassed_writes"]),
        "quotas": tier1["quotas"], "policies": tier1["policies"],
        "unmanaged_resident": eng.pool.resident(-2),
        "steps": len(eng.decodes), "prefills": len(eng.prefills),
        "decode_ms": 1e3 * sum(e - a for a, e, _ in eng.decodes)
        / max(len(eng.decodes), 1),
        "prefill_ms": 1e3 * sum(e - a for a, e, _ in eng.prefills)
        / max(len(eng.prefills), 1),
    }
    summary = None
    if trace:
        # the traced tail: the same loop for TRACE_SECONDS more under the
        # profiler, which costs the host time; the window is untraced
        prof = tr.profiler(dev)
        prof.__enter__()
        eng.span.on = True
        for rec in pending:
            submit(rec.client)
        w0 = time.time_ns()
        serve(time.perf_counter() + TRACE_SECONDS)
        w1 = time.time_ns()
        eng.span.on = False
        prof.__exit__(None, None, None)
        t_tr = time.perf_counter()
        summary = tr.summarize(prof, (w0, w1), eng.span.by_name)
        print(f"portbench: trace of {summary['events']} device operations "
              f"in the tail ({summary['outside']} outside) read in "
              f"{time.perf_counter() - t_tr:.1f} s", file=sys.stderr)
        del prof
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    records = list(eng.records.values())
    finished = [r for r in records
                if r.done_at is not None and t0 <= r.done_at <= t_close]
    failed = sum(1 for r in finished if r.lost)
    lost = sum(r.lost for r in finished)
    notes["finished"] = len(finished)
    prefills, decodes, bound = eng.prefills, eng.decodes, dict(eng.bound_s)
    page = eng.page
    # the check: free the program's state, then score a sample
    rng = tf.run_rng(seed, 2)
    pick = list(rng.permutation(len(finished))[:int(mix["check_requests"])])
    longest = max(range(len(finished)),
                  key=lambda i: len(finished[i].req.prompt)
                  + len(finished[i].req.generated), default=None)
    if longest is not None and longest not in pick:
        pick.append(longest)
    sample = [finished[i] for i in sorted(pick)]
    for r in records:
        r.metas = []
    del eng, traffic
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_chk = time.perf_counter()
    if sample:
        compared, drops, notes["readings"], ctl = _check(
            params, cfg, reference, sample, page, limits, fallbacks, lost,
            control)
        if control:
            notes["control"] = ctl
    else:
        compared = {"no_request_finished": [1, 0]}
        drops = 0
    notes.update(check_s=time.perf_counter() - t_chk,
                 checked_requests=len(sample),
                 checked_tokens=sum(len(r.req.generated) for r in sample),
                 moe_dropped_choices=drops)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        device_info.update(busy_s=summary["busy_s"],
                           window_s=summary["window_s"])
    print(f"portbench: window notes {notes}", file=sys.stderr)
    return ServeRun(cfg=cfg, seconds=seconds, setup_s=setup_s, t0=t0,
                    t_end=t_end, t_close=t_close, records=records,
                    prefills=prefills, decodes=decodes,
                    rebalance_s=rebalance_s, rebalances=rebalances,
                    bound_s=bound, trace=summary, attempted=attempted,
                    failed=failed, compared=compared, device=device_info,
                    notes=notes, family=family)


def percentile(values: list[float], q: float) -> float | None:
    """The ``q``-th percentile by linear interpolation (numpy's default),
    over every value; None when there are none."""
    return float(np.percentile(values, q)) if values else None


def gaps_ms(run: ServeRun) -> list[float]:
    """Every gap between consecutive tokens of a request, in ms, both ends
    in the window."""
    out = []
    for r in run.records:
        s = r.stamps
        out += [(b - a) * 1e3 for a, b in zip(s, s[1:])
                if run.in_window(a) and run.in_window(b)]
    return out


def ttfts_ms(run: ServeRun) -> list[float]:
    """Submission to first token, in ms, of every request submitted in
    the window."""
    return [(r.stamps[0] - r.submit) * 1e3 for r in run.records
            if run.t0 <= r.submit < run.t_end and r.stamps]


def window_flops(run: ServeRun) -> float:
    """Model FLOPs of the prompts prefilled and the tokens decoded in the
    window (the family's ``model_flops``)."""
    pre = [s for a, e, s in run.prefills if run.in_window(e)]
    ctx = [c for a, e, lens in run.decodes if run.in_window(e) for c in lens]
    return run.family.model_flops(run.cfg, pre, ctx)

