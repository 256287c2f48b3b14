"""Multi-tenant continuous-batching serving engine over the paged pool.

The port of the reference's ``src/repro/serve/engine.py``, on PyTorch's
eager ops and the port's model layer (``models/``).  Request lifecycle:

  * prefill: the prompt, zero-padded to whole pages, goes through the
    model once (``prefill_with_kv``: every layer's attention through
    ``flash_attention`` on the card) and its KV is kept layer-stacked;
    the prompt is cut into pages; pages whose content key (tenant,
    prefix hash) is already in the HBM pool are *reused* (read events to
    ECI-Cache, no recompute charge); fresh pages are *admitted* per the
    tenant's write policy (write events).  As in the reference, the first
    generated token is the argmax at the *padded* last position.
  * decode: batched single-token steps (``_decode_step``); each layer's
    attention runs over the pool through per-request block tables with
    ``paged_attention`` (on the card the hand-written split-KV kernel,
    each row's pages cut into splits that stream through a shared-memory
    ring and are merged by log-sum-exp; its plain version on the CPU; the
    reference calls the plain version on every backend).  The in-flight
    token's own K/V, written into the pool only after the step, is handed
    to the same call (``k_self`` / ``v_self``) and folded into its
    log-sum-exp merge as one more partial; the reference regathers the
    pool to merge it afterwards (its ``_merge_self``), the same function.

The ECI manager observes the event stream; every ``window_events`` it
re-partitions page quotas and write policies across tenants (Actuator =
``BlockPool.enforce_quota``).  Pages served from the HBM pool avoid the
host-tier fetch penalty.  The engine runs on the device of its
parameters and pool.  While the HBM pool is down
(``TieredKVCache.fail_tier(1)``) ``step`` admits nothing: the in-flight
requests, whose KV is gone, are aborted and requeued from their prompts
(``aborted_restarts``), and new work waits for ``recover_tier``.

The engine serves the dense and MoE families over GQA attention (the
reference's ``engine.py:95``).  An MoE block routes within its group, as
the reference's: a prefill request is one group of its padded length, and
in a decode step each row is a group of one token (capacity 4), every
expert computed for every row (``_decode_step``, the reference's
``:277-281``).

Tracing (``core/profile.py``, the engine's ``profile``: the process
profile unless one is given).  ``serve.prefill`` is partitioned into
``.upload`` (the prompt's copy to the device, which waits on the stream),
``.forward`` (enqueueing ``prefill_with_kv``), ``.pages`` (the page loop:
prefix hashes, lookups, ECI events, page writes, allocation, pins) and
``.sample`` (the first token read back); ``serve.decode`` into ``.pages``,
``.upload`` (tables, lengths and tokens to the device), ``.forward``
(enqueueing ``_decode_step``, whose device spans
``serve.decode.attention`` and ``serve.decode.head`` time each layer's
``paged_attention`` with the fold and the fp32 head, on CUDA in one step
of ``DEVICE_EVERY``), ``.writeback`` (the new KV's indices copied,
which waits for the forward, and put into the pool), ``.sample`` and
``.finish``.  Counters: ``serve.pages.unmanaged`` (pages staged as tenant
-2), ``serve.pages.refused`` (page 0 standing in for a refused page),
``cache.evict.pressure`` and ``serve.decode.self_fold`` (one a decode
layer whose attention took the in-flight token).  Each ``Request``
carries its host stamps (``time.perf_counter_ns``): submitted, scheduled
(its prefill starts), first token and done.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.cache.block_pool import BlockPool
from repro_torch.cache.tiered import TieredKVCache
from repro_torch.core.profile import StageProfile, process_profile
from repro_torch.kernels.paged_attention.kernel import paged_attention
from repro_torch.models.attention import build_heads
from repro_torch.models.config import AttnKind, Family, ModelConfig
from repro_torch.models.layers import Param, apply_rope, rms_norm
from repro_torch.models.model import _attn_mlp_block, _ffn, _layer, _lm_head

__all__ = ["Request", "MultiTenantEngine", "prefill_with_kv"]


@dataclasses.dataclass
class Request:
    tenant: int
    prompt: np.ndarray                   # int32[S]
    max_new_tokens: int = 16
    rid: int = -1
    generated: list[int] = dataclasses.field(default_factory=list)
    pages: list[int] = dataclasses.field(default_factory=list)   # pool pids
    length: int = 0                      # tokens with KV in the pool
    done: bool = False
    # host stamps (perf_counter_ns); queue wait = scheduled - submit
    submit_ns: int = 0
    scheduled_ns: int = 0                # its prefill starts
    first_token_ns: int = 0
    done_ns: int = 0


def _prefix_key(tenant: int, tokens: np.ndarray) -> tuple:
    return (tenant, hash(tokens.tobytes()))


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in (Family.DENSE, Family.MOE):
        raise ValueError("the serving engine covers attention-KV families "
                         f"(dense, MoE), not {cfg.family.value}")
    if cfg.attn == AttnKind.MLA:
        raise ValueError("the serving engine pages GQA K/V heads, not MLA's "
                         "latent cache")


def prefill_with_kv(params: Param, cfg: ModelConfig, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward returning (fp32 last-position logits [B, V_padded],
    k [L, B, S, Hkv, D], v [L, B, S, Hkv, D])."""
    _check_family(cfg)
    hq, hkv = build_heads(cfg)
    b, s = tokens.shape
    h = params["embed"][tokens]
    positions = torch.arange(s, device=tokens.device)[None, :]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        x = rms_norm(h, p["ln1"], cfg.rms_eps)
        k = (x @ p["attn"]["wk"]).reshape(b, s, hkv, cfg.head_dim)
        v = (x @ p["attn"]["wv"]).reshape(b, s, hkv, cfg.head_dim)
        if cfg.qk_norm:
            k = rms_norm(k, p["attn"]["k_norm"], cfg.rms_eps)
        ks.append(apply_rope(k, positions, cfg.rope_theta))
        vs.append(v)
        h = _attn_mlp_block(p, h, cfg)
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = h[:, -1].float() @ _lm_head(params, cfg).float()
    return logits, torch.stack(ks), torch.stack(vs)


class MultiTenantEngine:
    """The serving engine on the device of ``params`` and the pool."""

    def __init__(self, cfg: ModelConfig, params: Param,
                 tiered: TieredKVCache, page_size: int = 16,
                 max_pages_per_seq: int = 64,
                 profile: StageProfile | None = None):
        _check_family(cfg)
        self.cfg, self.params = cfg, params
        self.device = params["embed"].device
        self.tiered = tiered
        self.pool: BlockPool = tiered.pool
        if self.pool.k_pages is not None \
                and self.pool.k_pages.device != self.device:
            raise ValueError(f"the pool lies on {self.pool.k_pages.device}, "
                             f"the parameters on {self.device}")
        self.page = page_size
        self.max_pages = max_pages_per_seq
        self.active: list[Request] = []
        self.waiting: list[Request] = []
        self._rid = 0
        self.completed: list[Request] = []
        self.aborted_restarts = 0    # requests restarted after a pool crash
        self.profile = profile if profile is not None else process_profile()
        # a profile given is handed to ``_decode_step``, which otherwise
        # takes the process profile too
        self._step_kw = {} if profile is None else {"profile": profile}

    # ------------------------------------------------------------ intake
    def submit(self, req: Request) -> None:
        req.rid = self._rid
        self._rid += 1
        req.submit_ns = time.perf_counter_ns()
        self.waiting.append(req)

    # ----------------------------------------------------------- prefill
    def _prefill_one(self, req: Request) -> None:
        cfg, page, prof = self.cfg, self.page, self.profile
        req.scheduled_ns = time.perf_counter_ns()
        with prof.span("serve.prefill"):
            with prof.span("serve.prefill.upload"):
                prompt = np.asarray(req.prompt, np.int32)
                S = len(prompt)
                n_pages = -(-S // page)
                pad = n_pages * page - S
                tok = torch.as_tensor(np.pad(prompt, (0, pad))[None, :],
                                      dtype=torch.int64, device=self.device)
            with prof.span("serve.prefill.forward"):
                logits, ks, vs = prefill_with_kv(self.params, cfg, tok)
            with prof.span("serve.prefill.pages"):
                self._prompt_pages(req, prompt, n_pages, ks, vs)
            with prof.span("serve.prefill.sample"):
                req.length = S
                req.generated.append(int(logits[0, :cfg.vocab_size].argmax()))
            req.first_token_ns = time.perf_counter_ns()
            self.active.append(req)

    def _prompt_pages(self, req: Request, prompt: np.ndarray, n_pages: int,
                      ks: torch.Tensor, vs: torch.Tensor) -> None:
        """Cut the prompt into pages: reuse those whose content key is in
        the HBM pool, admit fresh ones per the tenant's policy, stage the
        rest unmanaged, and pin every page the request takes."""
        page = self.page
        for pi in range(n_pages):
            key = _prefix_key(req.tenant, prompt[:(pi + 1) * page])
            pid = self.pool.lookup(key)
            if pid is not None:
                self.tiered.access_page(req.tenant, key, fresh=False)
            else:
                self.tiered.access_page(req.tenant, key, fresh=True)
                pid = self.pool.by_key.get(key)
                if pid is not None and self.pool.k_pages is not None:
                    sl = slice(pi * page, (pi + 1) * page)
                    self.pool.write_page(ks[:, 0, sl], vs[:, 0, sl], pid)
            if pid is None:
                # bypassed (RO) or over quota: the page logically lives in
                # the host tier; stage it unmanaged (tenant -2) so decode
                # can still attend: latency accounting treats it as a
                # host-tier fetch, and it never counts against quotas.
                pid = self._unmanaged_page()
                if pid is not None and self.pool.k_pages is not None:
                    sl = slice(pi * page, (pi + 1) * page)
                    self.pool.write_page(ks[:, 0, sl], vs[:, 0, sl], pid)
            if pid is not None:
                self.pool.pin(pid)
            req.pages.append(pid if pid is not None else 0)

    def _unmanaged_page(self) -> int | None:
        """A page staged outside every quota (tenant -2); None when the
        pool refuses it (the caller then stands page 0 in)."""
        pid, evicted = self.pool.allocate(-2, None, quota=None)
        if evicted:
            self.profile.count("cache.evict.pressure", len(evicted))
        self.profile.count("serve.pages.unmanaged" if pid is not None
                           else "serve.pages.refused")
        return pid

    # ------------------------------------------------------------ decode
    def _decode_batch(self) -> None:
        cfg, page, prof = self.cfg, self.page, self.profile
        reqs = [r for r in self.active if not r.done]
        if not reqs:
            return
        with prof.span("serve.decode"):
            B = len(reqs)
            with prof.span("serve.decode.pages"):
                # every request gets a page with room for the next token
                for r in reqs:
                    if r.length % page == 0:
                        key = (r.tenant, "decode", r.rid, r.length // page)
                        self.tiered.access_page(r.tenant, key, fresh=True)
                        pid = self.pool.by_key.get(key)
                        if pid is None:
                            pid = self._unmanaged_page()
                        if pid is not None:
                            self.pool.pin(pid)
                        r.pages.append(pid if pid is not None else 0)
            with prof.span("serve.decode.upload"):
                tables = np.zeros((B, self.max_pages), np.int32)
                lens = np.zeros((B,), np.int32)
                toks = np.zeros((B,), np.int64)
                for i, r in enumerate(reqs):
                    tables[i, :len(r.pages)] = r.pages
                    lens[i] = r.length
                    toks[i] = r.generated[-1]
                dev = self.device
                toks_d = torch.as_tensor(toks, device=dev)
                tables_d = torch.as_tensor(tables, device=dev)
                lens_d = torch.as_tensor(lens, device=dev)
            with prof.span("serve.decode.forward"):
                prof.next_round()
                logits, k_new, v_new = _decode_step(
                    self.params, self.pool.k_pages, self.pool.v_pages,
                    toks_d, tables_d, lens_d, cfg, **self._step_kw)
            with prof.span("serve.decode.writeback"):
                # the new token's KV into each request's current page
                pids = np.array([r.pages[r.length // page] for r in reqs])
                offs = np.array([r.length % page for r in reqs])
                L = self.pool.shape[0]
                li = torch.as_tensor(np.repeat(np.arange(L), B), device=dev)
                pi = torch.as_tensor(np.tile(pids, L), device=dev)
                oi = torch.as_tensor(np.tile(offs, L), device=dev)
                for pages, new in ((self.pool.k_pages, k_new),
                                   (self.pool.v_pages, v_new)):
                    pages[li, pi, oi] = new.reshape(L * B, *new.shape[2:]).to(
                        pages.dtype)
            with prof.span("serve.decode.sample"):
                nxt = logits[:, :cfg.vocab_size].argmax(dim=-1).tolist()
            with prof.span("serve.decode.finish"):
                prof.resolve()          # the step's device spans, no wait
                now = time.perf_counter_ns()
                for i, r in enumerate(reqs):
                    r.length += 1
                    r.generated.append(int(nxt[i]))
                    if len(r.generated) >= r.max_new_tokens:
                        r.done = True
                        r.done_ns = now
                        self.completed.append(r)
                        for pid in r.pages:       # pages stay cached (prefix
                            self.pool.unpin(pid)  # reuse), but evictable
                self.active = [r for r in self.active if not r.done]

    # ----------------------------------------------------- tier failures
    def _requeue_active(self) -> None:
        """After an HBM-pool crash every in-flight request's KV is gone:
        abort them and restart from the prompt (put at the front of
        ``waiting``, so they are admitted first once the tier recovers)."""
        for r in self.active:
            for pid in r.pages:
                self.pool.unpin(pid)       # a no-op after the crash
            r.pages = []
            r.generated = []
            r.length = 0
            r.done = False
            self.aborted_restarts += 1
        self.waiting[:0] = self.active
        self.active = []

    # -------------------------------------------------------------- loop
    def step(self) -> None:
        if self.tiered.tier_down(1):
            # admission control: no prefill or decode against a dead pool;
            # in-flight work restarts once, new work waits for recovery
            if self.active:
                self._requeue_active()
            return
        while self.waiting:
            self._prefill_one(self.waiting.pop(0))
        self._decode_batch()

    def run(self, max_steps: int = 256) -> None:
        for _ in range(max_steps):
            if not (self.waiting or self.active):
                break
            self.step()


def _decode_step(params: Param, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 toks: torch.Tensor, tables: torch.Tensor,
                 lens: torch.Tensor, cfg: ModelConfig, *,
                 profile: StageProfile | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched one-token decode over the paged pool (the reference's
    ``_decode_step_jit``).  Returns (fp32 logits [B, V_padded], the new
    token's k and v [L, B, Hkv, D], not yet in the pool).  Each layer's
    attention and the fp32 head are device spans of ``profile`` (the
    process profile when None): ``serve.decode.attention`` and
    ``serve.decode.head``; ``serve.decode.self_fold`` counts the layers."""
    _check_family(cfg)
    prof = profile if profile is not None else process_profile()
    dspan = prof.device_span
    dev = toks.device
    hq, hkv = build_heads(cfg)
    b, d = toks.shape[0], cfg.head_dim
    h = params["embed"][toks][:, None, :]
    positions = lens[:, None]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        a = p["attn"]
        x = rms_norm(h, p["ln1"], cfg.rms_eps)
        q = (x @ a["wq"]).reshape(b, 1, hq, d)
        k = (x @ a["wk"]).reshape(b, 1, hkv, d)
        v = (x @ a["wv"]).reshape(b, 1, hkv, d)
        if cfg.qk_norm:
            q = rms_norm(q, a["q_norm"], cfg.rms_eps)
            k = rms_norm(k, a["k_norm"], cfg.rms_eps)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        # q and the in-flight K/V in the pool's dtype (exact for a wider
        # pool, as the fp32 pools under bf16 models of the reference's
        # tests); back in q's after.  The in-flight position is folded into
        # the kernel's own log-sum-exp merge: the pool is not written here
        pd = k_pool.dtype
        q_, k_, v_ = q[:, 0].to(pd), k[:, 0].to(pd), v[:, 0].to(pd)
        with dspan("serve.decode.attention", dev):
            att = paged_attention(q_, k_pool[i], v_pool[i], tables, lens,
                                  k_self=k_, v_self=v_)
        prof.count("serve.decode.self_fold")
        att = att.to(q.dtype)
        h = h + att.reshape(b, 1, hq * d) @ a["wo"]
        h = h + _ffn(p, rms_norm(h, p["ln2"], cfg.rms_eps), cfg)
        ks.append(k[:, 0])
        vs.append(v[:, 0])
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    with dspan("serve.decode.head", dev):
        logits = h[:, 0].float() @ _lm_head(params, cfg).float()
    return logits, torch.stack(ks), torch.stack(vs)

