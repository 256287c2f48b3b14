"""The port's paged decode attention against the JAX reference.

* ``kernels.paged_attention.ref``: ``gather_pages`` and
  ``paged_attention_ref`` (the definition the CUDA ``paged_attention`` is
  held against) against the reference's on ``ref.SWEEP``
  (tests/test_kernels.py's three shapes and qwen3-0.6b's heads at page 8,
  16 and 32; tables random into the pool and 0-padded; lengths ending
  mid-page, on a page edge and at 1), float32 within 1e-6 and bfloat16
  within 2e-2 (one bf16 rounding of the output either way);
* the wrapper ``kernel.paged_attention`` on CPU tensors: exactly the
  plain version, no launch counted; the input checks the wrapper makes
  before it dispatches;
* ``paged_attention_split_ref``, the CUDA kernel's split-KV
  decomposition, against the reference's ``paged_attention_ref`` on
  ``SWEEP`` at several split counts (float32 2e-5, bfloat16 2e-2), and on
  rows whose length ends mid-page inside a split, leaves later splits
  empty, is 1 or is 0 (which gives 0, as the Pallas kernel); the split
  count ``kernel.split_count`` picks from the table's width;
* the in-flight position (``k_self`` / ``v_self``, the serving decode's
  new token, not yet pooled), at KV groups 1, 2 and 8 on rows of length
  0, mid-page, page-aligned and the table's full width: the plain version
  equals attention over the gathered positions with the token appended
  (float64, row by row), agrees with the pooled attention followed by the
  reference's regather-and-merge (``_merge_self``'s arithmetic, written
  out here), and the split decomposition at 1 and more splits equals it;
  a row of length 0 gives ``v_self`` exactly; the wrapper on the CPU is
  the plain version and checks the new arguments;
* ``slow``: the reference's Pallas kernel in interpret mode against the
  port's wrapper on the CPU, float32 at tests/test_kernels.py's 2e-5.

Inputs come from numpy seeds (``ref.sweep_arrays``).  The CUDA kernel
itself is held against ``paged_attention_ref`` on the card
(``tests/test_torch_gpu.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.kernel import \
    paged_attention as paged_attention_tpu
from repro.kernels.paged_attention.ref import gather_pages as gather_pages_jax
from repro.kernels.paged_attention.ref import \
    paged_attention_ref as paged_attention_ref_jax
from repro_torch.kernels.paged_attention.kernel import (MAX_SPLIT_PAGES,
                                                        paged_attention,
                                                        split_count)
from repro_torch.kernels.paged_attention.ref import (SWEEP, gather_pages,
                                                     paged_attention_ref,
                                                     paged_attention_split_ref,
                                                     sweep_arrays)

paged_attention_ref_jax = jax.jit(paged_attention_ref_jax)
NAMES = ("q", "k_pages", "v_pages", "block_tables", "seq_lens")


def _inputs(case, dtype, seed=0):
    """The case's arrays for both packages: q and pages in ``dtype`` (the
    same bf16 rounding on both sides), tables and lengths int32."""
    a = sweep_arrays(case, seed)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    ours = [torch.from_numpy(a[n]) for n in NAMES]
    ours[:3] = [t.to(dtype) for t in ours[:3]]
    theirs = [jnp.asarray(a[n], jdt if i < 3 else jnp.int32)
              for i, n in enumerate(NAMES)]
    return ours, theirs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SWEEP)
def test_paged_attention_ref_matches_reference(case, dtype):
    ours, theirs = _inputs(case, dtype)
    got = paged_attention_ref(*ours)
    want = np.asarray(paged_attention_ref_jax(*theirs), np.float32)
    assert got.dtype == dtype and got.shape == case[:2] + (case[3],)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-6
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_gather_pages_matches_reference():
    a = sweep_arrays(SWEEP[3], seed=1)
    got = gather_pages(torch.from_numpy(a["k_pages"]),
                       torch.from_numpy(a["block_tables"]))
    want = gather_pages_jax(jnp.asarray(a["k_pages"]),
                            jnp.asarray(a["block_tables"]))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_and_op_on_cpu_are_the_plain_version(dtype):
    """On CPU tensors the wrapper returns ``paged_attention_ref`` bit for
    bit, and no launch is counted."""
    before = paged_attention.launches
    for case in SWEEP:
        ours, _ = _inputs(case, dtype, seed=2)
        want = paged_attention_ref(*ours)
        assert torch.equal(paged_attention(*ours), want)
    assert paged_attention.launches == before


def test_wrapper_input_checks():
    ours, _ = _inputs(SWEEP[0], torch.float32)
    q, kp, vp, tables, lens = ours
    bad = [
        (q[:, :3], kp, vp, tables, lens),            # Hkv does not divide Hq
        (q, kp, vp[..., :32], tables, lens),         # k and v shapes differ
        (q[..., :32], kp, vp, tables, lens),         # head dims differ
        (q, kp, vp, tables[:1], lens),               # tables not [B, pps]
        (q, kp, vp, tables, lens[:1]),               # lengths not [B]
        (q, kp.double(), vp.double(), tables, lens),  # dtypes differ
    ]
    for args in bad:
        with pytest.raises(ValueError):
            paged_attention(*args)


@pytest.mark.parametrize("n_split", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SWEEP)
def test_split_ref_matches_reference(case, dtype, n_split):
    ours, theirs = _inputs(case, dtype, seed=5)
    got = paged_attention_split_ref(*ours, n_split)
    want = np.asarray(paged_attention_ref_jax(*theirs), np.float32)
    assert got.dtype == dtype and got.shape == case[:2] + (case[3],)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


# rows whose splits end past the length (empty partials), a length ending
# mid-page inside a split, lengths 1 and 0 (0 gives 0)
SPLIT_EDGES = [
    # B, Hq, Hkv, D, page, pages_per_seq, n_pool, seq_lens, n_split
    (3, 8, 4, 64, 16, 12, 64, (1, 100, 192), 4),
    (2, 16, 8, 128, 8, 16, 48, (0, 37), 5),
    (2, 4, 1, 32, 4, 9, 24, (35, 0), 9),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SPLIT_EDGES)
def test_split_ref_edges(case, dtype):
    *shape, n_split = case
    ours, theirs = _inputs(tuple(shape), dtype, seed=6)
    got = paged_attention_split_ref(*ours, n_split).float().numpy()
    want = np.asarray(paged_attention_ref_jax(*theirs), np.float32)
    live = np.asarray(shape[-1]) > 0
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got[live], want[live], rtol=tol, atol=tol)
    assert not got[~live].any()


@pytest.mark.parametrize("batch", [1, 4, 32, 512])
@pytest.mark.parametrize("pps,page,tile", [(136, 16, 64), (136, 16, 32),
                                           (1, 8, 64), (5000, 1, 64),
                                           (3, 32, 64), (0, 16, 64)])
def test_split_count(batch, pps, page, tile):
    """Whole pages cover the table with no split wholly past it; a split
    holds at least two tiles unless the table is shorter, and at most
    ``MAX_SPLIT_PAGES`` entries; at qwen3's decode (B 32, 8 KV heads, 136
    pages of 16) on 132 SMs: 3 splits of 46 pages, 17 of 8 at B 1 and 4."""
    n, per = split_count(batch, 8, pps, page, tile, 132)
    width = max(pps, 1)
    assert n >= 1 and 1 <= per <= MAX_SPLIT_PAGES
    assert n * per >= width and (n - 1) * per < width
    assert per * page >= min(2 * tile, width * page) or per == MAX_SPLIT_PAGES
    if (pps, page, tile) == (136, 16, 64):
        assert (n, per) == {1: (17, 8), 4: (17, 8), 32: (3, 46),
                            512: (1, 136)}[batch]


# the in-flight position: 2 KV heads of 64, pages of 8, tables of 6;
# rows of length 0, mid-page, page-aligned and the table's full width
SELF_LENS = (0, 13, 24, 48)
GROUPS = (1, 2, 8)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _self_inputs(group, dtype, seed=11):
    """A case with ``2 * group`` query heads over 2 KV heads and the
    in-flight K/V [B, 2, 64]: q, pages, tables, lengths, k_self, v_self."""
    case = (len(SELF_LENS), 2 * group, 2, 64, 8, 6, 32, SELF_LENS)
    ours, _ = _inputs(case, dtype, seed)
    rng = np.random.default_rng(seed + 1)
    ks, vs = (torch.from_numpy(rng.standard_normal(
        (len(SELF_LENS), 2, 64)).astype(np.float32)).to(dtype)
        for _ in range(2))
    return (*ours, ks, vs)


def _appended_attention(q, kp, vp, tables, lens, ks, vs):
    """Row by row in float64: softmax attention of q over the row's pooled
    positions, gathered page by page, with the in-flight one appended."""
    b, hq, d = q.shape
    page, g = kp.shape[1], hq // kp.shape[2]
    out = torch.empty(b, hq, d, dtype=torch.float64)
    for i in range(b):
        n = int(lens[i])
        pos = torch.arange(n)
        pid = tables[i].long()[pos // page]
        k = torch.cat([kp[pid, pos % page], ks[i][None]]).double()
        v = torch.cat([vp[pid, pos % page], vs[i][None]]).double()
        for h in range(hq):
            s = k[:, h // g] @ q[i, h].double() / math.sqrt(d)
            out[i, h] = torch.softmax(s, dim=0) @ v[:, h // g]
    return out


def _regather_merge(q, ks, vs, att_pool, kp, tables, lens):
    """The reference's ``_merge_self`` (its ``engine.py:293``): the pool's
    log-sum-exp rebuilt from a second gather of the pages in fp32, merged
    with the in-flight position's score."""
    rep = q.shape[1] // ks.shape[1]
    kr = ks.repeat_interleave(rep, dim=1)
    vr = vs.repeat_interleave(rep, dim=1)
    scale = 1.0 / math.sqrt(q.shape[-1])
    kg = gather_pages(kp, tables).repeat_interleave(rep, dim=2)
    s_pool = torch.einsum("bhd,bkhd->bhk", q.float(), kg.float()) * scale
    pos = torch.arange(kg.shape[1])
    s_pool = torch.where(pos[None, None, :] < lens[:, None, None], s_pool,
                         -1e30)
    lse_pool = torch.logsumexp(s_pool, dim=-1)
    s_self = torch.einsum("bhd,bhd->bh", q.float(), kr.float()) * scale
    lse_all = torch.logaddexp(lse_pool, s_self)
    return (att_pool.float() * torch.exp(lse_pool - lse_all)[..., None]
            + vr.float() * torch.exp(s_self - lse_all)[..., None]
            ).to(att_pool.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", GROUPS)
def test_ref_with_self_is_attention_with_the_token_appended(group, dtype):
    args = _self_inputs(group, dtype)
    got = paged_attention_ref(*args)
    want = _appended_attention(*args)
    assert got.dtype == dtype and got.shape == args[0].shape
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=tol,
                               atol=tol)
    # a row of length 0 is the in-flight position alone, exactly
    assert torch.equal(got[0], args[6][0].repeat_interleave(group, dim=0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", GROUPS)
def test_ref_with_self_matches_the_regather_merge(group, dtype):
    """The fold against the composition it replaces in the engine: pooled
    attention in q's dtype, then the regather-and-merge (one rounding of
    the pooled output more in bfloat16)."""
    q, kp, vp, tables, lens, ks, vs = _self_inputs(group, dtype, seed=12)
    got = paged_attention_ref(q, kp, vp, tables, lens, k_self=ks, v_self=vs)
    att = paged_attention_ref(q, kp, vp, tables, lens)
    want = _regather_merge(q, ks, vs, att, kp, tables, lens)
    tol = 1e-5 if dtype == torch.float32 else TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("n_split", [1, 2, 3, 6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", GROUPS)
def test_split_ref_with_self_matches_ref(group, dtype, n_split):
    args = _self_inputs(group, dtype, seed=13)
    got = paged_attention_split_ref(*args[:5], n_split, *args[5:])
    want = paged_attention_ref(*args)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)
    assert torch.equal(got[0], args[6][0].repeat_interleave(group, dim=0))


def test_split_ref_with_self_on_an_empty_table():
    q, kp, vp, tables, lens, ks, vs = _self_inputs(2, torch.float32)
    empty = tables[:, :0]
    got = paged_attention_split_ref(q, kp, vp, empty, torch.zeros_like(lens),
                                    3, ks, vs)
    assert torch.equal(got, vs.repeat_interleave(2, dim=1))
    assert not paged_attention_split_ref(q, kp, vp, empty, lens, 3).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_with_self_on_cpu_is_the_plain_version(dtype):
    before = (paged_attention.launches, paged_attention.self_folds)
    for group in GROUPS:
        args = _self_inputs(group, dtype, seed=14)
        assert torch.equal(paged_attention(*args[:5], k_self=args[5],
                                           v_self=args[6]),
                           paged_attention_ref(*args))
        assert torch.equal(paged_attention(*args[:5], k_self=None,
                                           v_self=None),
                           paged_attention_ref(*args[:5]))
    assert (paged_attention.launches, paged_attention.self_folds) == before


def test_wrapper_self_input_checks():
    q, kp, vp, tables, lens, ks, vs = _self_inputs(2, torch.float32)
    bad = [
        dict(k_self=ks),                              # v_self missing
        dict(v_self=vs),                              # k_self missing
        dict(k_self=ks[:, :1], v_self=vs[:, :1]),     # not [B, Hkv, D]
        dict(k_self=ks[:2], v_self=vs[:2]),           # B differs
        dict(k_self=ks, v_self=vs[..., :32]),         # shapes differ
        dict(k_self=ks.double(), v_self=vs.double()),  # dtype differs
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            paged_attention(q, kp, vp, tables, lens, **kw)


@pytest.mark.slow
@pytest.mark.parametrize("case", SWEEP)
def test_reference_pallas_kernel_matches_port(case):
    """The reference's Pallas kernel (interpret mode) against the port's
    wrapper on the same float32 inputs (tests/test_kernels.py:66's 2e-5)."""
    ours, theirs = _inputs(case, torch.float32)
    want = paged_attention_tpu(*theirs, interpret=True)
    np.testing.assert_allclose(paged_attention(*ours).numpy(),
                               np.asarray(want), rtol=2e-5, atol=2e-5)
