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
    ``paged_attention`` (the hand-written kernel on the card, its plain
    version on the CPU; the reference calls the plain version on every
    backend), and ``_merge_self`` folds in the in-flight token's
    own KV, which is written into the pool after the step.

The ECI manager observes the event stream; every ``window_events`` it
re-partitions page quotas and write policies across tenants (Actuator =
``BlockPool.enforce_quota``).  Pages served from the HBM pool avoid the
host-tier fetch penalty.  The engine runs on the device of its
parameters and pool.  The MoE family raises ``NotImplementedError``
naming ROADMAP §1 item 2.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.cache.block_pool import BlockPool
from repro_torch.cache.tiered import TieredKVCache
from repro_torch.kernels.paged_attention.kernel import paged_attention
from repro_torch.kernels.paged_attention.ref import gather_pages
from repro_torch.models.attention import build_heads, not_ported
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.layers import Param, apply_rope, rms_norm, swiglu
from repro_torch.models.model import _attn_mlp_block, _layer, _lm_head

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


def _prefix_key(tenant: int, tokens: np.ndarray) -> tuple:
    return (tenant, hash(tokens.tobytes()))


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family == Family.MOE:
        raise not_ported("the moe family's serving path")
    if cfg.family != Family.DENSE:
        raise ValueError("the serving engine covers attention-KV families "
                         f"(dense, MoE), not {cfg.family.value}")


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
                 max_pages_per_seq: int = 64):
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

    # ------------------------------------------------------------ intake
    def submit(self, req: Request) -> None:
        req.rid = self._rid
        self._rid += 1
        self.waiting.append(req)

    # ----------------------------------------------------------- prefill
    def _prefill_one(self, req: Request) -> None:
        cfg, page = self.cfg, self.page
        prompt = np.asarray(req.prompt, np.int32)
        S = len(prompt)
        n_pages = -(-S // page)
        pad = n_pages * page - S
        tok = torch.as_tensor(np.pad(prompt, (0, pad))[None, :],
                              dtype=torch.int64, device=self.device)
        logits, ks, vs = prefill_with_kv(self.params, cfg, tok)

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
                pid, _ = self.pool.allocate(-2, None, quota=None)
                if pid is not None and self.pool.k_pages is not None:
                    sl = slice(pi * page, (pi + 1) * page)
                    self.pool.write_page(ks[:, 0, sl], vs[:, 0, sl], pid)
            if pid is not None:
                self.pool.pin(pid)
            req.pages.append(pid if pid is not None else 0)
        req.length = S
        req.generated.append(int(logits[0, :cfg.vocab_size].argmax()))
        self.active.append(req)

    # ------------------------------------------------------------ decode
    def _decode_batch(self) -> None:
        cfg, page = self.cfg, self.page
        reqs = [r for r in self.active if not r.done]
        if not reqs:
            return
        B = len(reqs)
        # ensure every request has a page with room for the next token
        for r in reqs:
            if r.length % page == 0:
                key = (r.tenant, "decode", r.rid, r.length // page)
                self.tiered.access_page(r.tenant, key, fresh=True)
                pid = self.pool.by_key.get(key)
                if pid is None:
                    pid, _ = self.pool.allocate(-2, None, quota=None)
                if pid is not None:
                    self.pool.pin(pid)
                r.pages.append(pid if pid is not None else 0)

        tables = np.zeros((B, self.max_pages), np.int32)
        lens = np.zeros((B,), np.int32)
        toks = np.zeros((B,), np.int64)
        for i, r in enumerate(reqs):
            tables[i, :len(r.pages)] = r.pages
            lens[i] = r.length
            toks[i] = r.generated[-1]
        dev = self.device
        logits, k_new, v_new = _decode_step(
            self.params, self.pool.k_pages, self.pool.v_pages,
            torch.as_tensor(toks, device=dev),
            torch.as_tensor(tables, device=dev),
            torch.as_tensor(lens, device=dev), cfg)
        # write the new token's KV into each request's current page
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
        nxt = logits[:, :cfg.vocab_size].argmax(dim=-1).tolist()
        for i, r in enumerate(reqs):
            r.length += 1
            r.generated.append(int(nxt[i]))
            if len(r.generated) >= r.max_new_tokens:
                r.done = True
                self.completed.append(r)
                for pid in r.pages:           # pages stay cached (prefix
                    self.pool.unpin(pid)      # reuse), but become evictable
        self.active = [r for r in self.active if not r.done]

    # -------------------------------------------------------------- loop
    def step(self) -> None:
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
                 lens: torch.Tensor, cfg: ModelConfig
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched one-token decode over the paged pool (the reference's
    ``_decode_step_jit``).  Returns (fp32 logits [B, V_padded], the new
    token's k and v [L, B, Hkv, D], not yet in the pool)."""
    _check_family(cfg)
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
        # q in the pool's dtype (exact for a wider pool, as the fp32 pools
        # under bf16 models of the reference's tests); back in q's after
        att = paged_attention(q[:, 0].to(k_pool.dtype), k_pool[i],
                              v_pool[i], tables, lens).to(q.dtype)
        # exact online merge of the in-flight token's KV (not yet pooled)
        att = _merge_self(q[:, 0], k[:, 0], v[:, 0], att, k_pool[i], tables,
                          lens, d, hq, hkv)
        h = h + att.reshape(b, 1, hq * d) @ a["wo"]
        hn = rms_norm(h, p["ln2"], cfg.rms_eps)
        h = h + swiglu(hn, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                       p["mlp"]["w_down"])
        ks.append(k[:, 0])
        vs.append(v[:, 0])
    h = rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = h[:, 0].float() @ _lm_head(params, cfg).float()
    return logits, torch.stack(ks), torch.stack(vs)


def _merge_self(q: torch.Tensor, k_self: torch.Tensor, v_self: torch.Tensor,
                att_pool: torch.Tensor, k_pg: torch.Tensor,
                tables: torch.Tensor, lens: torch.Tensor, head_dim: int,
                hq: int, hkv: int) -> torch.Tensor:
    """Exact online merge of the current token's KV with pooled attention:
    the pool's log-sum-exp is recomputed from a second gather of the pages
    (as the reference does), in fp32 with the KV heads repeated."""
    rep = hq // hkv
    kr = k_self.repeat_interleave(rep, dim=1)
    vr = v_self.repeat_interleave(rep, dim=1)
    scale = 1.0 / math.sqrt(head_dim)
    kp = gather_pages(k_pg, tables).repeat_interleave(rep, dim=2)
    s_pool = torch.einsum("bhd,bkhd->bhk", q.float(), kp.float()) * scale
    pos = torch.arange(kp.shape[1], device=q.device)
    mask = pos[None, None, :] < lens[:, None, None]
    s_pool = torch.where(mask, s_pool, -1e30)
    lse_pool = torch.logsumexp(s_pool, dim=-1)
    s_self = torch.einsum("bhd,bhd->bh", q.float(), kr.float()) * scale
    lse_all = torch.logaddexp(lse_pool, s_self)
    w_pool = torch.exp(lse_pool - lse_all)[..., None]
    w_self = torch.exp(s_self - lse_all)[..., None]
    return (att_pool.float() * w_pool
            + vr.float() * w_self).to(att_pool.dtype)
