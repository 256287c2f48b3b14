"""Loop-aware cost of a step as it runs: the counterpart of the
reference's ``src/repro/launch/hlo_analysis.py``.

The reference parses the compiled HLO of a jitted step and multiplies each
``while`` body by its trip count.  PyTorch has no HLO, so
``analyze_step(fn, *args)`` runs the step under a ``TorchDispatchMode``
and counts what it dispatches, on any device (``meta`` too, where nothing
is computed):

  * FLOPs: 2 M N K per matrix product (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``: every ``x @ W`` and einsum lands on one), by
    ``torch.utils.flop_counter``'s formulas.  Eager Python loops run every
    iteration, so each layer and microbatch is counted, which is what
    ``analyze_hlo``'s trip counts recover.  Elementwise FLOPs are left
    out, as the reference's.
  * bytes: the sum of every op's output size (views excluded), the
    reference's write-once proxy for HBM traffic.
  * the kernel-backed ops (``prefill_attention``, ``mamba2_ssd_op``,
    ``paged_attention``): the hand kernels launch through ``ctypes`` and
    are invisible to the mode (and to the profiler), while on ``meta`` and
    the CPU their plain versions run instead.  So each call is counted by
    one formula of its useful work (``costs.kernel_op``), the same
    whichever implementation runs, and nothing dispatched inside it.
    Under autograd each runs inside its ``autograd.Function`` on every
    device, and its backward is counted the same way, by a backward-work
    formula (``<op>.backward``), not by the plain recompute it dispatches:
    a train step counts the same on the card, the CPU and ``meta``.
    ``while_trip_counts`` holds each such op's calls: the eager loop's
    trip counts (one a layer, a microbatch).
  * collectives: the port's device-to-device moves between mesh positions,
    by kind (``costs.moved``): ``gather`` an all-gather, the sharded
    train step's gradient blocks a reduce-scatter, its norm an
    all-reduce, the pipeline's hand-offs a collective-permute,
    ``compressed_psum`` an all-reduce of int8 payloads.  Logical shards
    of one device are counted as if they were distinct devices.

The results carry ``HloCost``'s field names (``flops``, ``bytes``,
``collective_bytes``, ``coll_total``, ``while_trip_counts``).
"""
from __future__ import annotations

import collections
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import costs

__all__ = ["StepCost", "analyze_step"]

_aten = torch.ops.aten
_PRODUCTS = {op: flop_registry[op] for op in (_aten.mm, _aten.addmm,
                                               _aten.bmm, _aten.baddbmm)}


@dataclasses.dataclass
class StepCost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: dict | None = None
    while_trip_counts: dict | None = None

    @property
    def coll_total(self) -> float:
        return float(sum((self.collective_bytes or {}).values()))


def _out_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (tuple, list)):
        return sum(_out_bytes(o) for o in out)
    return 0


class _Analyzer(TorchDispatchMode):
    """Counts products, output bytes, kernel-backed ops and moves."""

    def __init__(self):
        super().__init__()
        self.cost = StepCost(collective_bytes={}, while_trip_counts={})
        self.calls: collections.Counter = collections.Counter()
        self.inside = 0

    def enter_kernel(self, name: str, flops: float, nbytes: float) -> None:
        if not self.inside:
            self.cost.flops += flops
            self.cost.bytes += nbytes
            self.calls[name] += 1
        self.inside += 1

    def exit_kernel(self) -> None:
        self.inside -= 1

    def collective(self, kind: str, nbytes: float) -> None:
        if not self.inside:
            cb = self.cost.collective_bytes
            cb[kind] = cb.get(kind, 0.0) + float(nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.inside:
            product = _PRODUCTS.get(func.overloadpacket)
            if product is not None:
                self.cost.flops += product(*args, **kwargs, out_val=out)
            if not func.is_view:
                self.cost.bytes += _out_bytes(out)
        return out


def analyze_step(fn, *args, **kwargs) -> StepCost:
    """Runs ``fn(*args, **kwargs)`` once and returns its cost (module
    docstring)."""
    analyzer = _Analyzer()
    costs.ACTIVE.append(analyzer)
    try:
        with analyzer:
            fn(*args, **kwargs)
    finally:
        costs.ACTIVE.pop()
    analyzer.cost.while_trip_counts = dict(analyzer.calls)
    return analyzer.cost
