"""The plain reference of the ``gqa`` family: the served models' forward
in fp32, in PyTorch (dense and MoE decoders, GQA with RoPE in every layer).

It imports nothing of the program under test (``repro_torch``), of JAX
or of the JAX package.  It takes the configuration file's published keys
and the benchmark's own weight tensors (the port's layout, widened to
fp32 one layer at a time, so that it fits beside the weights), and
follows the serving engine's documented semantics:

* a prompt of S tokens is zero-padded to whole pages (P tokens) and run
  causally; its first generated token is scored at the *padded* last
  position P - 1;
* each later token is scored at position S + j, attending the prompt's
  S positions and the tokens generated before it (never the pads);
* an MoE block routes a prompt (with its pads, in position order) as one
  group and each generated token as a group of its own: fp32 router
  logits, top-k with ties to the lower expert, a softmax over the k
  chosen logits, queue positions by arrival, and a choice past the
  group's capacity ``max(ceil(cf * n * k / E), 4)`` dropped; the shared
  expert is added ungated.

All of it runs as one masked forward per request: the prompt, its pads
and the generated tokens, the pads and the generated tokens each seeing
the prompt and their own kind.  ``precision="fp8"`` is the control: every
product's operands rounded to float8 e4m3 (weights per output column,
activations per row, scaled by their largest magnitude), accumulated in
fp32.  ``precision="bf16"`` rounds the operands to bf16 instead: what
bf16 alone does to these numbers, beside the program's.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Layout", "served_logits"]

FP8_MAX = 448.0


class Layout:
    """One request's positions in the masked forward: the prompt (segment
    0), its pads (1) and its generated tokens but the last (2)."""

    def __init__(self, prompt: np.ndarray, served: list[int], page: int):
        s, n = len(prompt), len(served)
        p = -(-s // page) * page
        self.tokens = np.concatenate([np.asarray(prompt, np.int64),
                                      np.zeros(p - s, np.int64),
                                      np.asarray(served[:-1], np.int64)])
        self.pos = np.concatenate([np.arange(s), np.arange(s, p),
                                   np.arange(s, s + n - 1)])
        self.seg = np.concatenate([np.zeros(s, np.int64),
                                   np.ones(p - s, np.int64),
                                   np.full(n - 1, 2, np.int64)])
        # row scoring served[0] (the padded last), then served[1:]
        self.scored = np.concatenate([[p - 1], p + np.arange(n - 1)])
        self.group = p                  # the prompt's routing group

    def mask(self, device) -> torch.Tensor:
        pos = torch.as_tensor(self.pos, device=device)
        seg = torch.as_tensor(self.seg, device=device)
        return (pos[None, :] <= pos[:, None]) & (
            (seg[None, :] == 0) | (seg[None, :] == seg[:, None]))


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class _Ops:
    def __init__(self, precision: str):
        if precision not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"precision fp32, bf16 or fp8, not "
                             f"{precision!r}")
        self.precision = precision

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [..., k] @ w [k, n] in fp32, from operands rounded to fp8 or
        to bf16 (the program's precision, for comparison only)."""
        if self.precision == "fp8":
            x, w = _fp8(x, -1), _fp8(w, -2)
        elif self.precision == "bf16":
            x, w = x.bfloat16().float(), w.bfloat16().float()
        return x @ w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + w)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, device=x.device,
                                         dtype=torch.float32) / half)
    ang = pos[:, None].float() * freqs                       # [T, half]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(h, lay, mask, p, cfg, ops):
    t = h.shape[0]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // hq
    eps, theta = cfg["rms_norm_eps"], float(cfg["rope_theta"])
    x = _rms(h, p["ln1"], eps)
    q = ops.mm(x, p["wq"]).view(t, hq, hd)
    k = ops.mm(x, p["wk"]).view(t, hkv, hd)
    v = ops.mm(x, p["wv"]).view(t, hkv, hd)
    if "q_norm" in p:
        q, k = _rms(q, p["q_norm"], eps), _rms(k, p["k_norm"], eps)
    pos = torch.as_tensor(lay.pos, device=h.device)
    q, k = _rope(q, pos, theta), _rope(k, pos, theta)
    rep = hq // hkv
    k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    a = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    out = torch.einsum("hqk,khd->qhd", a, v).reshape(t, hq * hd)
    return h + ops.mm(out, p["wo"])


def _swiglu(x, wg, wu, wd, ops):
    return ops.mm(F.silu(ops.mm(x, wg)) * ops.mm(x, wu), wd)


def _route(x, router, cfg, lay, ops):
    """(expert idx [T, k], gates [T, k], keep [T, k]) of one request."""
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    cf = cfg["port"]["capacity_factor"]
    logits = ops.mm(x, router)
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    gates = torch.softmax(top, dim=-1)
    keep = torch.ones_like(idx, dtype=torch.bool)
    g = lay.group                       # prompt + pads, in position order
    cap = max(int(math.ceil(cf * g * k / e)), 4)
    onehot = F.one_hot(idx[:g], e).sum(1)                     # [g, E]
    before = torch.cumsum(onehot, 0) - onehot
    keep[:g] = before.gather(1, idx[:g]) < cap
    # each generated token is a group of one: k <= 4 <= its capacity
    return idx, gates, keep


def _moe(xs, lays, p, cfg, ops):
    """The MoE block over every request's tokens at once: routing per
    request, each expert's product over all the tokens it keeps."""
    x = torch.cat(xs)
    routes = [_route(xi, p["router"], cfg, lay, ops)
              for xi, lay in zip(xs, lays)]
    idx = torch.cat([r[0] for r in routes])
    gates = torch.cat([r[1] for r in routes])
    keep = torch.cat([r[2] for r in routes])
    tok = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(idx)
    tok, ex, gt = tok[keep], idx[keep], gates[keep]
    y = _swiglu(x, p["shared_gate"], p["shared_up"], p["shared_down"], ops)
    for e in torch.unique(ex).tolist():
        sel = ex == e
        ye = _swiglu(x[tok[sel]], p["w_gate"][e], p["w_up"][e],
                     p["w_down"][e], ops)
        y.index_add_(0, tok[sel], ye * gt[sel, None])
    drops = int((~keep).sum())
    return list(torch.split(y, [len(xi) for xi in xs])), drops


def _layer(params: dict, i: int) -> dict:
    lay = params["layers"]
    out = {"ln1": lay["ln1"][i].float(), "ln2": lay["ln2"][i].float()}
    out.update({k: v[i].float() for k, v in lay["attn"].items()})
    out.update({k: v[i].float() for k, v in lay["mlp"].items()})
    return out


def served_logits(params: dict, cfg: dict, requests: list, page: int,
                  precision: str = "fp32") -> tuple[list, int]:
    """fp32 logits [len(served), vocab_size] that score each request's
    served tokens, and the MoE choices dropped by capacity (0 for a dense
    model).  ``requests``: (prompt int array, served token list) pairs;
    ``page``: the engine's page size (the prompt's padding)."""
    # on the card an fp32 product may run in TF32 unless told not to
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops = _Ops(precision)
    dev = params["embed"].device
    eps = cfg["rms_norm_eps"]
    lays = [Layout(pr, sv, page) for pr, sv in requests]
    masks = [lay.mask(dev) for lay in lays]
    hs = [params["embed"][torch.as_tensor(lay.tokens, device=dev)].float()
          for lay in lays]
    drops = 0
    with torch.no_grad():
        for i in range(cfg["num_hidden_layers"]):
            p = _layer(params, i)
            hs = [_attention(h, lay, m, p, cfg, ops)
                  for h, lay, m in zip(hs, lays, masks)]
            xs = [_rms(h, p["ln2"], eps) for h in hs]
            if cfg.get("num_experts"):
                ys, dropped = _moe(xs, lays, p, cfg, ops)
                drops += dropped
            else:
                ys = [_swiglu(x, p["w_gate"], p["w_up"], p["w_down"], ops)
                      for x in xs]
            hs = [h + y for h, y in zip(hs, ys)]
            del p
        head = (params["embed"].T if cfg["tie_word_embeddings"]
                else params["lm_head"])[:, :cfg["vocab_size"]].float()
        fn = params["final_norm"].float()
        out = [ops.mm(_rms(h[torch.as_tensor(lay.scored, device=dev)], fn,
                           eps), head)
               for h, lay in zip(hs, lays)]
    return out, drops
