"""Comparison schemes as configurations of ``ECICacheManager``.

  * ``eci``     — the paper's scheme (URD sizing + Alg. 3 policies).
  * ``centaur`` — the paper's head-to-head baseline [Koller+, ICAC'15]:
    TRD-based MRC sizing, Eq.-2 optimization when infeasible, WB
    everywhere.

The reference's other schemes (``etica``, ``static``,
``reuse_intensity``, ``global``) are not ported yet.
"""
from __future__ import annotations

from repro_torch.core.manager import ECICacheManager

__all__ = ["make_manager", "SCHEMES"]

SCHEMES = ("eci", "centaur")


def make_manager(scheme: str, capacity: int, tenant_names: list[str],
                 **kw) -> ECICacheManager:
    """Factory for the ported schemes (same knobs as ECICacheManager;
    ``device=None`` means the CUDA card)."""
    if scheme == "eci":
        return ECICacheManager(capacity, tenant_names, rd_kind="urd",
                               adaptive_policy=True, **kw)
    if scheme == "centaur":
        return ECICacheManager(capacity, tenant_names, rd_kind="trd",
                               adaptive_policy=False, **kw)
    raise NotImplementedError(
        f"scheme {scheme!r} is not ported yet (ported: {SCHEMES}; ROADMAP: "
        f"modules queue)")
