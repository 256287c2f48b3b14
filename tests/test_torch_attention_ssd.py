"""The port's prefill attention and SSD scan against the JAX reference.

* ``kernels.flash_attention.ref.attention_ref`` (the dense definition
  the CUDA ``flash_attention`` is held against) against the reference's
  ``attention_ref`` over ``tests/test_kernels.py``'s sweep, float32 and
  bfloat16, at its tolerances (2e-5 / 2e-2), plus head dim 112, grouped
  KV heads (16 / 8, which the reference takes repeated), ragged
  ``Sq != Skv``, ``window=96`` and ``Dv != D``;
* ``blockwise_attention`` (the port's prefill on the CPU, and the
  wrapper's CPU route) against the reference's ``layers.blockwise_attention``
  and against ``attention_ref``;
* ``kernels.mamba2_ssd.ref``: ``seg_from_dA``, the sequential
  ``mamba2_ssd_ref`` and the chunked ``mamba2_ssd_chunked`` (the
  wrapper's CPU route) against the reference's sequential oracle over
  ``tests/test_kernels.py``'s sweep at its tolerance (3e-6 after scaling by
  the largest output), B and C per row or shared by a group of rows;
  ``ops.mamba2_ssd_op`` against the reference's ``mamba2_ssd_op``.
* ``slow``: the reference's Pallas kernels in interpret mode against the
  port's wrappers on the CPU.

Inputs come from numpy seeds.  The CUDA kernels themselves are held
against these plain versions on the card (``tests/test_torch_gpu.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import \
    flash_attention as flash_attention_tpu
from repro.kernels.flash_attention.ref import attention_ref as attention_ref_jax
from repro.kernels.mamba2_ssd.kernel import mamba2_ssd as mamba2_ssd_tpu
from repro.kernels.mamba2_ssd.ops import mamba2_ssd_op as mamba2_ssd_op_jax
from repro.kernels.mamba2_ssd.ref import mamba2_ssd_ref as mamba2_ssd_ref_jax
from repro.kernels.mamba2_ssd.ref import seg_from_dA as seg_from_dA_jax
from repro.models.layers import blockwise_attention as blockwise_jax
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ops import prefill_attention
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     blockwise_attention)
from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd
from repro_torch.kernels.mamba2_ssd.ops import mamba2_ssd_op
from repro_torch.kernels.mamba2_ssd.ref import (mamba2_ssd_chunked,
                                                mamba2_ssd_ref, seg_from_dA)

# the reference's oracles, jitted once per shape (eager dispatch compiles
# every primitive on its own, several times slower)
attention_ref_jax = jax.jit(attention_ref_jax,
                            static_argnames=("causal", "window"))
blockwise_jax = jax.jit(blockwise_jax, static_argnames=(
    "causal", "window", "block_q", "block_kv"))
mamba2_ssd_ref_jax = jax.jit(mamba2_ssd_ref_jax)
seg_from_dA_jax = jax.jit(seg_from_dA_jax, static_argnums=1)

# tests/test_kernels.py:37-43, then head dim 112, GQA 16/8, ragged, window
ATTN_CASES = [
    # B, Hq, Hkv, Sq, Skv, D, Dv, causal, window
    (1, 2, 2, 128, 128, 64, 64, True, 0),
    (2, 2, 2, 96, 160, 64, 64, True, 0),
    (1, 1, 1, 256, 256, 128, 128, False, 0),
    (1, 2, 2, 256, 256, 64, 64, True, 96),
    (2, 4, 4, 64, 64, 32, 32, True, 0),
    (1, 4, 4, 200, 200, 112, 112, True, 0),
    (1, 16, 8, 96, 160, 112, 112, True, 96),
    (2, 4, 2, 70, 70, 16, 48, True, 0),
]
# tests/test_kernels.py:75-79
SSD_CASES = [(2, 128, 32, 16, 32), (4, 256, 64, 128, 64), (1, 64, 16, 8, 16)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _qkv(case, seed, dtype_name):
    b, hq, hkv, sq, skv, d, dv, _, _ = case
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((b, hq, sq, d), np.float32),
              rng.standard_normal((b, hkv, skv, d), np.float32),
              rng.standard_normal((b, hkv, skv, dv), np.float32))
    tdt, jdt = DTYPES[dtype_name]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a, jdt) for a in arrays])


def _repeat(x, rep):
    """The reference's kernels take KV heads repeated per query head."""
    return jnp.repeat(x, rep, axis=1)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_ref_matches_reference(case, dtype):
    (q, k, v), (jq, jk, jv) = _qkv(case, 0, dtype)
    causal, window = case[7], case[8]
    rep = case[1] // case[2]
    want = attention_ref_jax(jq, _repeat(jk, rep), _repeat(jv, rep),
                             causal=causal, window=window)
    got = attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == (case[0], case[1], case[3],
                                                  case[6])
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_blockwise_matches_reference_and_dense(case):
    """The port's CPU prefill (the wrapper's CPU route and ``ops``) against
    the reference's blockwise attention and the dense definition, with
    blocks small enough to visit ragged and fully masked tiles."""
    (q, k, v), (jq, jk, jv) = _qkv(case, 1, "float32")
    causal, window = case[7], case[8]
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    want = blockwise_jax(jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
                         jnp.swapaxes(jv, 1, 2), causal=causal,
                         window=window, block_q=64, block_kv=32)
    got = blockwise_attention(t(q), t(k), t(v), causal=causal, window=window,
                              block_q=64, block_kv=32)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)
    dense = attention_ref(q, k, v, causal=causal, window=window)
    wrapped = flash_attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(wrapped), _np(dense), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        _np(prefill_attention(t(q), t(k), t(v), causal=causal,
                              window=window)), _np(t(dense)),
        rtol=2e-5, atol=2e-5)


def test_flash_attention_wrapper_checks_shapes():
    q = torch.zeros((1, 3, 8, 16))
    with pytest.raises(ValueError, match="Hkv dividing Hq"):
        flash_attention(q, torch.zeros((1, 2, 8, 16)),
                        torch.zeros((1, 2, 8, 16)))
    with pytest.raises(ValueError, match="device and dtype"):
        flash_attention(q, q.double(), q)
    assert flash_attention.launches == 0        # no launch on the CPU


def _ssd_inputs(bh, s, p, n, seed, groups=None):
    """The reference sweep's input laws, from a numpy seed; B and C per
    row (``groups=None``) or shared by ``bh // groups`` rows."""
    rng = np.random.default_rng(seed)
    g = bh if groups is None else groups
    x = rng.standard_normal((bh, s, p), np.float32) * 0.5
    B = rng.standard_normal((g, s, n), np.float32) * 0.5
    C = rng.standard_normal((g, s, n), np.float32) * 0.5
    dA = -rng.random((bh, s), np.float32) * 0.5
    return x, B, C, dA


def _scaled_close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=3e-6)


@pytest.mark.parametrize("bh,s,p,n,chunk", SSD_CASES)
def test_ssd_plain_versions_match_reference(bh, s, p, n, chunk):
    x, B, C, dA = _ssd_inputs(bh, s, p, n, seed=bh + s)
    want = np.asarray(mamba2_ssd_ref_jax(*map(jnp.asarray, (x, B, C, dA))))
    t = [torch.from_numpy(a) for a in (x, B, C, dA)]
    seg = seg_from_dA(t[3], chunk)
    np.testing.assert_allclose(
        seg.numpy(), np.asarray(seg_from_dA_jax(jnp.asarray(dA), chunk)),
        rtol=1e-6, atol=1e-6)
    _scaled_close(mamba2_ssd_ref(*t), want)
    _scaled_close(mamba2_ssd_chunked(*t[:3], seg, chunk=chunk), want)
    _scaled_close(mamba2_ssd(*t[:3], seg, chunk=chunk), want)
    _scaled_close(mamba2_ssd_op(*t, chunk=chunk), want)
    assert mamba2_ssd.launches == 0             # no launch on the CPU
    np.testing.assert_allclose(
        mamba2_ssd_op(*t, chunk=chunk).numpy(),
        np.asarray(mamba2_ssd_op_jax(*map(jnp.asarray, (x, B, C, dA)),
                                     chunk=chunk, use_kernel=False)),
        atol=3e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_shared_B_C_equal_repeated(groups):
    """B and C shared by a group of rows (the model's layout, no
    broadcast copy) give what the reference's per-row copies give."""
    bh, s, p, n, chunk = 4, 128, 16, 8, 32
    x, B, C, dA = _ssd_inputs(bh, s, p, n, seed=groups, groups=groups)
    rep = bh // groups
    want = mamba2_ssd_ref_jax(jnp.asarray(x),
                              jnp.asarray(np.repeat(B, rep, axis=0)),
                              jnp.asarray(np.repeat(C, rep, axis=0)),
                              jnp.asarray(dA))
    t = [torch.from_numpy(a) for a in (x, B, C, dA)]
    _scaled_close(mamba2_ssd_op(*t, chunk=chunk), want)
    _scaled_close(mamba2_ssd_ref(*t), want)


def test_ssd_wrapper_checks_shapes():
    x = torch.zeros((4, 64, 16))
    B = torch.zeros((3, 64, 8))
    seg = torch.zeros((4, 64, 1))
    with pytest.raises(ValueError, match="G dividing BH"):
        mamba2_ssd(x, B, B, seg, chunk=16)
    with pytest.raises(ValueError, match="multiple of chunk"):
        mamba2_ssd(x, B[:2], B[:2], seg, chunk=48)


# ------------------------------------- the reference's Pallas kernels
@pytest.mark.slow
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ATTN_CASES[:5])
def test_flash_attention_matches_reference_kernel(case, dtype):
    (q, k, v), (jq, jk, jv) = _qkv(case, 2, dtype)
    causal, window = case[7], case[8]
    want = flash_attention_tpu(jq, jk, jv, causal=causal, window=window,
                               block_q=64, block_kv=64, interpret=True)
    got = flash_attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


@pytest.mark.slow
@pytest.mark.parametrize("bh,s,p,n,chunk", SSD_CASES)
def test_ssd_matches_reference_kernel(bh, s, p, n, chunk):
    x, B, C, dA = _ssd_inputs(bh, s, p, n, seed=7)
    want = mamba2_ssd_tpu(jnp.asarray(x), jnp.asarray(B), jnp.asarray(C),
                          seg_from_dA_jax(jnp.asarray(dA), chunk),
                          chunk=chunk, interpret=True)
    got = mamba2_ssd_op(*[torch.from_numpy(a) for a in (x, B, C, dA)],
                        chunk=chunk)
    _scaled_close(got, want)
