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
* ``slow``: the reference's Pallas kernel in interpret mode against the
  port's wrapper on the CPU, float32 at tests/test_kernels.py's 2e-5.

Inputs come from numpy seeds (``ref.sweep_arrays``).  The CUDA kernel
itself is held against ``paged_attention_ref`` on the card
(``tests/test_torch_gpu.py``).
"""
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


@pytest.mark.slow
@pytest.mark.parametrize("case", SWEEP)
def test_reference_pallas_kernel_matches_port(case):
    """The reference's Pallas kernel (interpret mode) against the port's
    wrapper on the same float32 inputs (tests/test_kernels.py:66's 2e-5)."""
    ours, theirs = _inputs(case, torch.float32)
    want = paged_attention_tpu(*theirs, interpret=True)
    np.testing.assert_allclose(paged_attention(*ours).numpy(),
                               np.asarray(want), rtol=2e-5, atol=2e-5)
