"""Activation-sharding context: the rules the model's ``constrain`` hints
name, without threading a mesh through every model function.

The port of the reference's ``src/repro/distributed/ctx.py``.
``activation_rules`` installs named ``NamedSharding``s (e.g. "act", the
per-layer hidden state, [DP, model, None] under sequence parallelism);
``constrain(x, name)`` resolves the rule for ``x`` with the reference's
divisibility fix (an axis that does not divide its dim is dropped).  The
reference hands the result to ``with_sharding_constraint`` so GSPMD
places the tensor; the port's mesh is one controller whose model code
runs on whole tensors (``distributed.sharding``), so the hint changes no
value and ``constrain`` returns ``x`` itself, never a copy.  ``resolve``
gives the sharding the hint names, for whoever wants to see it.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from repro_torch.distributed.sharding import DP, NamedSharding, P

__all__ = ["activation_rules", "constrain", "current_rules",
           "default_decode_rules", "default_train_rules", "resolve"]

_RULES: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "activation_rules", default=None)


@contextlib.contextmanager
def activation_rules(rules: dict):
    """rules: name -> NamedSharding, in force inside the ``with``."""
    tok = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(tok)


def current_rules() -> dict | None:
    return _RULES.get()


def resolve(x: torch.Tensor, name: str) -> NamedSharding | None:
    """The sharding rule ``name`` gives ``x`` (None when no such rule is
    in force), each axis that does not divide its dim dropped
    (``src/repro/distributed/ctx.py:41-62``)."""
    rules = _RULES.get()
    if not rules or name not in rules:
        return None
    sh = rules[name]
    sizes = dict(zip(sh.mesh.axis_names, sh.mesh.devices.shape))
    fixed = []
    for i, entry in enumerate(tuple(sh.spec)
                              + (None,) * (x.ndim - len(sh.spec))):
        if entry is None or i >= x.ndim:
            fixed.append(None)
            continue
        total = 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            total *= sizes.get(a, 1)
        fixed.append(entry if x.shape[i] % total == 0 else None)
    return NamedSharding(sh.mesh, P(*fixed[:x.ndim]))


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """The hint ``name`` on ``x``: the rule is resolved (a bad rule
    raises, as the reference's) and ``x`` itself is returned."""
    resolve(x, name)
    return x


def default_decode_rules(mesh) -> dict:
    """Decode-only rules: the weight-stationary MLP (the MLP input's
    d_model over ``data``)."""
    return {"dec_mlp": NamedSharding(mesh, P(None, None, "data"))}


def default_train_rules(mesh, *, sp: bool = True,
                        attn_heads: bool = True) -> dict:
    """Baseline rules for train / prefill: DP batch, optional SP sequence
    (the Megatron-SP schedule's "gathered" and "mlp_mid"), head-sharded
    q/k/v inside attention, and the MoE buffers' groups over DP and
    experts over ``model``."""
    dp = DP(mesh)
    seq = "model" if sp else None
    rules = {"act": NamedSharding(mesh, P(dp, seq, None))}
    if attn_heads:
        rules["attn_qkv"] = NamedSharding(mesh, P(dp, None, "model", None))
    if sp:
        rules["gathered"] = NamedSharding(mesh, P(dp, None, None))
        rules["mlp_mid"] = NamedSharding(mesh, P(dp, None, "model"))
    rules["moe_xe"] = NamedSharding(mesh, P(dp, "model", None, None))
    return rules
