"""The one traffic generator: a closed loop of clients over tenant mixes.

A mix file (``portbench/traffic/<name>.json``) gives the clients, each
tenant's share of the requests and the laws of its prompt and output
lengths, and, for a tenant that shares prefixes, its system prompts
(``system_prompts`` of ``system_tokens`` each; with ``system_prompts``
0, every request opens with ``system_tokens`` tokens of its own).  The
*sizes* come from a fixed deck: ``deck`` requests whose lengths sit at
evenly spaced quantiles of each law, dealt into blocks of ``block`` that
each hold the whole mix (paired by permutations drawn from the mix's own
``deck_seed``), so every run seed serves the same sizes, block by block.
The run's seed orders the blocks and the requests in each (a new order
each time the deck is used up) and draws every token.  Requests are
handed out in the order the clients ask for them, so a run is the same
from the same seed.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["Spec", "Traffic", "deck", "quantile_lengths", "run_rng"]


@dataclasses.dataclass(frozen=True)
class Spec:
    """One request's sizes: its tenant, the tokens it adds after any
    system prompt, its output tokens and which system prompt it opens
    with (-1: none)."""
    tenant: str
    unique: int
    output: int
    system: int = -1


def run_rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use of the run's seed (any whole
    number, negative ones folded into 64 bits)."""
    return np.random.default_rng([seed % 2**64, stream])


def quantile_lengths(law: dict, n: int) -> np.ndarray:
    """``n`` whole lengths at the quantiles (k + 1/2) / n of ``law``:
    ``uniform`` or ``log_uniform`` over [low, high]."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = float(law["low"]), float(law["high"])
    if law["dist"] == "uniform":
        x = lo + u * (hi - lo)
    elif law["dist"] == "log_uniform":
        x = lo * (hi / lo) ** u
    else:
        raise ValueError(f"unknown length law {law['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def deck(mix: dict) -> list[list[Spec]]:
    """The mix's fixed multiset of request sizes (independent of the run's
    seed), in blocks of ``block`` requests.  Each block holds each
    tenant's share of it, one length from each stratum of K neighbouring
    quantiles (K the number of blocks), so any run of whole blocks serves
    nearly the same mix of sizes."""
    rng = np.random.default_rng(mix["deck_seed"])
    size, per = int(mix["deck"]), int(mix["block"])
    if size % per:
        raise ValueError(f"deck {size} is not whole blocks of {per}")
    k = size // per
    shares = [t["share"] for t in mix["tenants"]]
    if not math.isclose(sum(shares), 1.0):
        raise ValueError(f"tenant shares sum to {sum(shares)}, not 1")
    blocks: list[list[Spec]] = [[] for _ in range(k)]
    for t in mix["tenants"]:
        n_blk = t["share"] * per
        if not math.isclose(n_blk, round(n_blk)):
            raise ValueError(f"{t['name']}: share {t['share']} of a block "
                             f"of {per} is not whole")
        n = int(round(n_blk)) * k
        unique = quantile_lengths(t["prompt"], n)
        output = quantile_lengths(t["output"], n)
        n_sys = int(t.get("system_prompts", 0))
        # stratum i of K lengths deals them to the blocks in turn, back
        # and forth (so no block gets the short end of every stratum);
        # outputs to a permutation of the blocks, not tied to the prompts
        order = np.array([np.arange(k) if i % 2 == 0 else np.arange(k)[::-1]
                          for i in range(n // k)])
        deal = order + k * np.arange(n // k)[:, None]          # [strata, k]
        blk_out = rng.permutation(k)
        for j in range(k):
            u = unique[deal[:, j]]
            o = rng.permutation(output[deal[:, blk_out[j]]])
            blocks[j] += [Spec(t["name"], int(a), int(b),
                               int(i % n_sys) if n_sys else -1)
                          for i, (a, b) in enumerate(zip(u, o))]
    return blocks


class Traffic:
    """Hands out requests from the deck in an order drawn from ``seed``;
    the tokens too come from ``seed``.  ``next()`` returns (spec, prompt
    tokens int32, max new tokens)."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.vocab = mix, vocab
        self.deck = deck(mix)
        self._order = run_rng(seed, 0)
        self._tokens = run_rng(seed, 1)
        self.system, self._prefix = {}, {}
        for t in mix["tenants"]:
            n = int(t.get("system_prompts", 0))
            # a system prompt's length with no shared prompts: each
            # request opens with that many tokens of its own
            self._prefix[t["name"]] = (0 if n else
                                       int(t.get("system_tokens", 0)))
            self.system[t["name"]] = [
                self._tokens.integers(0, vocab, int(t["system_tokens"]),
                                      dtype=np.int32) for _ in range(n)]
        self._queue: list[Spec] = []

    def next(self) -> tuple[Spec, np.ndarray, int]:
        if not self._queue:         # the blocks, and each block, in an
            for j in self._order.permutation(len(self.deck)):   # order of
                blk = self.deck[j]                               # the seed
                self._queue += [blk[i] for i in
                                self._order.permutation(len(blk))]
            self._queue.reverse()
        spec = self._queue.pop()
        tail = self._tokens.integers(0, self.vocab,
                                     self._prefix[spec.tenant] + spec.unique,
                                     dtype=np.int32)
        prompt = (np.concatenate([self.system[spec.tenant][spec.system],
                                  tail]) if spec.system >= 0 else tail)
        return spec, prompt, spec.output
