"""Comparison schemes as configurations of ``ECICacheManager``.

  * ``eci``     — the paper's scheme (URD sizing + Alg. 3 policies).
  * ``etica``   — its two-level configuration: pass ``capacity2``
    (L2 blocks) and optionally ``t_fast2``/``w_threshold2``; each tenant
    owns an (L1, L2) hierarchy with per-level sizing and policies.
  * ``centaur`` — the paper's head-to-head baseline [Koller+, ICAC'15]:
    TRD-based MRC sizing, Eq.-2 optimization when infeasible, WB
    everywhere.

The reference's other schemes (``static``, ``reuse_intensity``,
``global``) are not ported yet.
"""
from __future__ import annotations

from repro_torch.core.manager import ECICacheManager

__all__ = ["make_manager", "SCHEMES"]

SCHEMES = ("eci", "etica", "centaur")


def make_manager(scheme: str, capacity: int, tenant_names: list[str],
                 **kw) -> ECICacheManager:
    """Factory for the ported schemes (same knobs as ECICacheManager;
    ``device=None`` means the CUDA card)."""
    if scheme in ("eci", "etica"):
        if scheme == "etica" and int(kw.get("capacity2", 0)) <= 0:
            raise ValueError("scheme 'etica' needs capacity2 > 0")
        return ECICacheManager(capacity, tenant_names, rd_kind="urd",
                               adaptive_policy=True, **kw)
    if scheme == "centaur":
        return ECICacheManager(capacity, tenant_names, rd_kind="trd",
                               adaptive_policy=False, **kw)
    raise NotImplementedError(
        f"scheme {scheme!r} is not ported yet (ported: {SCHEMES}; ROADMAP: "
        f"modules queue)")
