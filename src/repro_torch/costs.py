"""The hooks through which ``launch.cost_analysis`` sees what its dispatch
mode cannot.

The hand-written kernels launch through ``ctypes``, so neither a
``TorchDispatchMode`` nor the profiler sees their work; on ``meta`` and
on the CPU their plain versions run instead and would be counted op by
op.  So each kernel-backed op (``prefill_attention``, ``mamba2_ssd_op``,
``paged_attention``) wraps its dispatch, and the backward of its
autograd Function, in ``kernel_op`` with one formula of its useful work,
the same whichever implementation runs, and the analyzer counts that and
nothing inside.  The port's device-to-device
moves (``place`` / ``gather``, the sharded step's gradient reduction, the
pipeline's hand-offs, ``compressed_psum``) call ``moved`` with their
collective's kind and bytes.  With no analyzer active both are no-ops.
"""
from __future__ import annotations

import contextlib

__all__ = ["kernel_op", "moved"]

# the analyzers in force, innermost last (launch.cost_analysis pushes)
ACTIVE: list = []


@contextlib.contextmanager
def kernel_op(name: str, work):
    """Counts one call of a kernel-backed op as ``work() -> (flops,
    bytes)`` (called only while an analyzer is active), and nothing the
    implementation dispatches inside it."""
    if not ACTIVE:
        yield
        return
    analyzer = ACTIVE[-1]
    analyzer.enter_kernel(name, *work())
    try:
        yield
    finally:
        analyzer.exit_kernel()


def moved(kind: str, nbytes: float) -> None:
    """Counts ``nbytes`` moved between mesh devices by a collective of
    ``kind`` (``all-gather``, ``reduce-scatter``, ``all-reduce``,
    ``collective-permute``)."""
    if ACTIVE:
        ACTIVE[-1].collective(kind, nbytes)
