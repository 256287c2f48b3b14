"""Plain PyTorch versions of the SSD chunked scan of ``mamba2_ssd``.

* ``mamba2_ssd_ref`` is the sequential recurrence, the definition the
  kernel is held against (the reference's ``mamba2_ssd/ref.py``);
* ``seg_from_dA`` turns per-step ``dt * A`` into the within-chunk cumsum
  the kernel takes;
* ``mamba2_ssd_chunked`` is the chunked form: the reference's inline scan
  (``src/repro/models/mamba2.py:127-175``) laid out per (batch * head)
  row, with the scores of a group of heads formed once.  It is what the
  wrapper ``kernel.mamba2_ssd`` returns for a CPU tensor, so the model
  runs it on the CPU, as the reference does off-TPU.

B and C are ``[G, S, N]``, shared by the ``BH / G`` consecutive rows of a
group (G = BH when every row has its own); all math is fp32.
"""
from __future__ import annotations

import torch

__all__ = ["SEQUENTIAL_CASES", "SWEEP", "mamba2_ssd_chunked",
           "mamba2_ssd_ref", "seg_from_dA"]

# the shapes at which the kernel is held to these on the card: the
# reference's sweep (tests/test_kernels.py:75-79), held to the sequential
# form too, then B/C shared by groups of rows and zamba2's head dim,
# state and chunk for two batch rows, held to the chunked form (at chunk
# 256 the sequential recurrence carries its own fp32 rounding over
# hundreds of steps)
SWEEP = [
    # BH, S, P, N, chunk, groups of B/C
    (2, 128, 32, 16, 32, 2), (4, 256, 64, 128, 64, 4), (1, 64, 16, 8, 16, 1),
    (8, 192, 16, 16, 64, 2), (2 * 112, 512, 64, 64, 256, 2),
]
SEQUENTIAL_CASES = 3


def _clip_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, -60.0, 0.0))


def seg_from_dA(dA: torch.Tensor, chunk: int) -> torch.Tensor:
    """[BH, S] per-step dA -> within-chunk cumsum [BH, S, 1]."""
    bh, s = dA.shape
    return torch.cumsum(dA.reshape(bh, s // chunk, chunk), dim=-1
                        ).reshape(bh, s, 1)


def mamba2_ssd_ref(x_dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                   dA: torch.Tensor) -> torch.Tensor:
    """Sequential scan: ``h_t = h_{t-1} exp(dA_t) + B_t x_t``,
    ``y_t = C_t . h_t``.  x_dt [BH, S, P], B/C [G, S, N], dA [BH, S]."""
    bh, s, p = x_dt.shape
    rep = bh // B.shape[0]
    Bf = B.float().repeat_interleave(rep, dim=0)
    Cf = C.float().repeat_interleave(rep, dim=0)
    x = x_dt.float()
    h = torch.zeros((bh, B.shape[-1], p), device=x.device)
    ys = []
    for t in range(s):
        h = h * torch.exp(dA[:, t].float())[:, None, None] \
            + Bf[:, t, :, None] * x[:, t, None, :]
        ys.append(torch.einsum("bn,bnp->bp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x_dt.dtype)


def mamba2_ssd_chunked(x_dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                       seg: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """The chunked SSD scan, the kernel's function on any device.

    x_dt [BH, S, P]; B/C [G, S, N]; seg [BH, S, 1] (``seg_from_dA``);
    ``S % chunk == 0``.  Per chunk: ``y = ((C B^T) * L) x + (C h) *
    exp(seg)``, ``L[i, j] = exp(seg_i - seg_j)`` for ``j <= i``; the
    fp32 state h [N, P] is carried across chunks; exponents are clipped to
    [-60, 0].  Returns [BH, S, P] in x_dt's dtype.
    """
    bh, s, p = x_dt.shape
    g, _, n = B.shape
    q, nc = chunk, s // chunk
    x = x_dt.float().reshape(g, bh // g, nc, q, p)
    Bc = B.float().reshape(g, nc, q, n)
    Cc = C.float().reshape(g, nc, q, n)
    sg = seg.float().reshape(g, bh // g, nc, q)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    h = torch.zeros((g, bh // g, n, p), device=x.device)
    ys = []
    for c in range(nc):
        sq, xq = sg[:, :, c], x[:, :, c]                     # [g,r,Q], [g,r,Q,P]
        L = torch.where(tri, _clip_exp(sq[..., :, None] - sq[..., None, :]),
                        0.0)                                 # [g,r,Q,Q]
        scores = torch.einsum("gin,gjn->gij", Cc[:, c], Bc[:, c])
        y_intra = torch.einsum("grij,grjp->grip", scores[:, None] * L, xq)
        y_inter = torch.einsum("gin,grnp->grip", Cc[:, c], h) \
            * _clip_exp(sq)[..., None]
        seg_last = sq[..., -1:]                              # [g,r,1]
        s_new = torch.einsum("gjn,grjp->grnp", Bc[:, c],
                             _clip_exp(seg_last - sq)[..., None] * xq)
        h = h * _clip_exp(seg_last)[..., None] + s_new
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=2).reshape(bh, s, p).to(x_dt.dtype)
