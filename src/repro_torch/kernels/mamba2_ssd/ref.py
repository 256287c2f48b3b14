"""Plain PyTorch versions of the SSD chunked scan of ``mamba2_ssd``.

* ``mamba2_ssd_ref`` is the sequential recurrence, the definition the
  kernel is held against (the reference's ``mamba2_ssd/ref.py``);
* ``seg_from_dA`` turns per-step ``dt * A`` into the within-chunk cumsum
  the kernel takes;
* ``mamba2_ssd_chunked`` is the chunked form: the reference's inline scan
  (``src/repro/models/mamba2.py:127-175``) laid out per (batch * head)
  row, with the scores of a group of heads formed once.  It is what the
  wrapper ``kernel.mamba2_ssd`` returns for a CPU tensor, so the model
  runs it on the CPU, as the reference does off-TPU;
* ``chunk_state_ref``, ``state_pass_ref`` and ``chunk_scan_ref`` are the
  plain versions of the kernel's three passes (each chunk's own state,
  the sequential pass over chunk states, the per-chunk output), and
  ``mamba2_ssd_passes`` their composition, the same function again.

B and C are ``[G, S, N]``, shared by the ``BH / G`` consecutive rows of a
group (G = BH when every row has its own); all math is fp32.
"""
from __future__ import annotations

import torch

__all__ = ["SEQUENTIAL_CASES", "SWEEP", "chunk_scan_ref", "chunk_state_ref",
           "mamba2_ssd_chunked", "mamba2_ssd_passes", "mamba2_ssd_ref",
           "seg_from_dA", "state_pass_ref"]

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


def chunk_state_ref(x_dt: torch.Tensor, B: torch.Tensor, seg: torch.Tensor,
                    *, chunk: int) -> torch.Tensor:
    """Pass 1: each chunk's own state ``s_c = sum_j exp(clip(seg_last -
    seg_j)) B_j^T x_j`` for every chunk but the last (whose state nothing
    reads): [BH, S / chunk - 1, N, P] fp32."""
    bh, s, p = x_dt.shape
    g, _, n = B.shape
    nc = s // chunk
    x = x_dt.float().reshape(g, bh // g, nc, chunk, p)[:, :, :-1]
    Bc = B.float().reshape(g, nc, chunk, n)[:, :-1]
    sg = seg.float().reshape(g, bh // g, nc, chunk)[:, :, :-1]
    w = _clip_exp(sg[..., -1:] - sg)                         # [g,r,nc-1,Q]
    st = torch.einsum("gcjn,grcjp->grcnp", Bc, w[..., None] * x)
    return st.reshape(bh, nc - 1, n, p)


def state_pass_ref(states: torch.Tensor, seg: torch.Tensor, *,
                   chunk: int) -> torch.Tensor:
    """Pass 2: the states entering chunks 1 .. S / chunk - 1, ``h_{c+1} =
    exp(clip(seg_last,c)) h_c + s_c`` from ``h_0 = 0``, in the layout of
    ``states`` (slot c holds the state entering chunk c + 1)."""
    bh, nc1, n, p = states.shape
    d = _clip_exp(seg.float().reshape(bh, -1, chunk)[:, :nc1, -1])
    h = torch.zeros((bh, n, p), device=states.device)
    out = []
    for c in range(nc1):
        h = d[:, c, None, None] * h + states[:, c].float()
        out.append(h)
    return torch.stack(out, 1) if out else states.float().clone()


def chunk_scan_ref(x_dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                   seg: torch.Tensor, h_in: torch.Tensor, *,
                   chunk: int) -> torch.Tensor:
    """Pass 3: per chunk, ``y_i = exp(clip(seg_i)) C_i . h_c + sum_{j<=i}
    (C_i . B_j) exp(clip(seg_i - seg_j)) x_j`` with h_c the state entering
    chunk c (``h_in[:, c - 1]``, zero for chunk 0).  Returns [BH, S, P]
    in x_dt's dtype."""
    bh, s, p = x_dt.shape
    g, _, n = B.shape
    q, nc = chunk, s // chunk
    x = x_dt.float().reshape(g, bh // g, nc, q, p)
    Bc = B.float().reshape(g, nc, q, n)
    Cc = C.float().reshape(g, nc, q, n)
    sg = seg.float().reshape(g, bh // g, nc, q)
    h = h_in.float().reshape(g, bh // g, nc - 1, n, p)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c in range(nc):
        sq = sg[:, :, c]
        L = torch.where(tri, _clip_exp(sq[..., :, None] - sq[..., None, :]),
                        0.0)
        scores = torch.einsum("gin,gjn->gij", Cc[:, c], Bc[:, c])
        y = torch.einsum("grij,grjp->grip", scores[:, None] * L, x[:, :, c])
        if c > 0:
            y = y + torch.einsum("gin,grnp->grip", Cc[:, c], h[:, :, c - 1]) \
                * _clip_exp(sq)[..., None]
        ys.append(y)
    return torch.stack(ys, dim=2).reshape(bh, s, p).to(x_dt.dtype)


def mamba2_ssd_passes(x_dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                      seg: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """The three passes composed: the chunked SSD scan as the kernel
    splits it (the same function as ``mamba2_ssd_chunked``)."""
    states = state_pass_ref(chunk_state_ref(x_dt, B, seg, chunk=chunk), seg,
                            chunk=chunk)
    return chunk_scan_ref(x_dt, B, C, seg, states, chunk=chunk)
