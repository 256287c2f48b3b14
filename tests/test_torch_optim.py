"""The port's optimiser and gradient compression against the JAX
reference, on the CPU.

* ``adamw_update`` under every schedule (cosine, linear, constant), with
  clipping active and inactive, on a tree of bfloat16 and float32 leaves
  that keep their dtypes: the fp32 ``master``, ``mu`` and ``nu`` and the
  norm at rel 1e-6 (float32 arithmetic in another order: ``pow`` and
  ``cos`` of another library), the count exactly, the new parameters at
  one rounding step of their dtype; the schedules alone at every step of
  a run, warm-up and decay.
* ``quantize_int8`` and ``dequantize_int8`` exactly, ties rounding half
  to even; error feedback keeps the drift bounded
  (``tests/test_train.py``'s compression test).
* ``compressed_psum`` over 2 and 8 logical CPU shards against the
  reference's under ``jax.vmap(..., axis_name="pod")``: the int8
  payloads, scales and error states exactly, the means to rel 1e-6.

Inputs come from numpy seeds.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro.optim import compression as RCmp
from repro_torch.distributed.sharding import ShardMesh
from repro_torch.optim.adamw import (AdamWConfig, _lr, adamw_update,
                                     init_opt_state)
from repro_torch.optim.compression import (compressed_psum, dequantize_int8,
                                           init_error_state, quantize_int8)
from repro_torch.tree import tree_items, tree_map

SCHEDULES = ["cosine", "linear", "constant"]
SHAPES = {"w": ((6, 5), "bfloat16"), "norm": ((5,), "float32"),
          "layers": {"a": ((3, 4, 4), "bfloat16"), "b": ((3, 4), "float32")}}


def _tree(seed, scale=1.0, dtypes=True):
    """A numpy tree of SHAPES' leaves (float32 values; ``dtypes`` marks
    which become bfloat16)."""
    rng = np.random.default_rng(seed)

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        shape, dtype = node
        return (rng.standard_normal(shape).astype(np.float32) * scale,
                dtype if dtypes else "float32")
    return make(SHAPES)


def _jax(tree):
    return jax.tree.map(lambda x: jnp.asarray(x[0], x[1]), tree,
                        is_leaf=lambda x: isinstance(x, tuple))


def _torch(tree):
    return tree_map(lambda x: torch.from_numpy(x[0]).to(getattr(torch,
                                                                x[1])), tree)


def _close(got, want, rtol):
    for name, g in tree_items(got):
        w = dict(tree_items(want))[name]
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()) + 1e-30,
                                   err_msg=name)


@pytest.mark.parametrize("clip", [1e6, 1.0])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_adamw_update_matches_reference(schedule, clip):
    """Three updates from the same trees (the second and third from the
    first's state), clipping inactive (clip 1e6) or active (gradients of
    norm about 30 against 1)."""
    cfg = dict(lr_peak=1e-2, warmup_steps=2, total_steps=5,
               clip_norm=clip, schedule=schedule)
    p_np = _tree(0)
    params, rparams = _torch(p_np), _jax(p_np)
    opt, ropt = init_opt_state(params), RA.init_opt_state(rparams)
    for i in range(3):
        g_np = _tree(10 + i, scale=3.0)
        new, opt, gnorm = adamw_update(_torch(g_np), opt, AdamWConfig(**cfg),
                                       params=params)
        rnew, ropt, rnorm = RA.adamw_update(_jax(g_np), ropt,
                                            RA.AdamWConfig(**cfg),
                                            params=rparams)
        assert float(gnorm) == pytest.approx(float(rnorm), rel=1e-6)
        assert int(opt["count"]) == int(ropt["count"]) == i + 1
        assert opt["count"].dtype == torch.int32
        for k in ("master", "mu", "nu"):
            _close(opt[k], ropt[k], 1e-6)
        for name, leaf in tree_items(new):
            old = dict(tree_items(params))[name]
            assert leaf.dtype == old.dtype, name
            # the new leaf is the master rounded to its dtype
            assert torch.equal(leaf, dict(tree_items(opt["master"]))[name]
                               .to(old.dtype)), name
        step = 2.0 ** -7 if any(x[1] == "bfloat16" for _, x in
                                tree_items(p_np)) else 1e-6
        _close(new, rnew, step)
        params, rparams = new, rnew
    if clip == 1.0:
        assert float(gnorm) > 10 * clip        # clipping was active


def test_adamw_without_params_gives_bfloat16():
    p = {"w": torch.ones(3, 3), "n": torch.zeros(3)}
    new, _, _ = adamw_update(tree_map(torch.ones_like, p), init_opt_state(p),
                             AdamWConfig())
    assert all(t.dtype == torch.bfloat16 for _, t in tree_items(new))


def test_init_opt_state_copies_master():
    p = {"w": torch.randn(4, 4)}
    opt = init_opt_state(p)
    assert opt["master"]["w"].data_ptr() != p["w"].data_ptr()
    assert torch.equal(opt["master"]["w"], p["w"])
    assert opt["mu"]["w"].dtype == opt["nu"]["w"].dtype == torch.float32
    assert opt["count"].dtype == torch.int32 and int(opt["count"]) == 0


def test_gradient_clipping():
    """``tests/test_train.py``'s: a 1e6 gradient is clipped to norm 1."""
    p = {"w": torch.ones((4, 4))}
    _, opt2, gnorm = adamw_update({"w": torch.full((4, 4), 1e6)},
                                  init_opt_state(p), AdamWConfig(clip_norm=1.0),
                                  params=p)
    assert float(gnorm) > 1e6 - 1
    assert float(opt2["mu"]["w"].abs().max()) < 1.0


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedules_match_reference(schedule):
    cfg = dict(lr_peak=3e-4, warmup_steps=7, total_steps=40,
               schedule=schedule)
    steps = np.arange(0, 45, dtype=np.float32)
    got = np.array([float(_lr(torch.tensor(s), AdamWConfig(**cfg)))
                    for s in steps])
    want = np.array([float(RA._lr(jnp.float32(s), RA.AdamWConfig(**cfg)))
                     for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    if schedule != "constant":
        assert got[0] == 0.0 and got[7] == pytest.approx(3e-4)
        assert got[-1] == pytest.approx(0.0, abs=1e-12)


def test_quantize_int8_matches_reference_exactly():
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((64, 64)).astype(np.float32),
          # max |x| 127 -> scale 1 (1e-12 is lost in f32): x / scale lands
          # on halves, which round to even
          np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                   np.float32),
          np.zeros((5,), np.float32),
          rng.standard_normal((3, 7)).astype(np.float32) * 1e-20]
    for x in xs:
        q, s = quantize_int8(torch.from_numpy(x))
        rq, rs = RCmp.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)
        np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                      np.asarray(RCmp.dequantize_int8(rq, rs)))
    q, _ = quantize_int8(torch.from_numpy(xs[1]))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


def test_compression_error_feedback():
    """``tests/test_train.py``'s: one int8 step of error, and the
    residual keeps the accumulated drift bounded."""
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 64)).astype(np.float32))
    q, s = quantize_int8(g)
    assert float((dequantize_int8(q, s) - g).abs().max() / g.abs().max()) \
        < 0.02
    err = init_error_state({"g": g})["g"]
    total_true, total_sent = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(50):
        g32 = g + err
        q, s = quantize_int8(g32)
        deq = dequantize_int8(q, s)
        err = g32 - deq
        total_true += g
        total_sent += deq
    assert float((total_sent - total_true).abs().max()) < 0.05


@pytest.mark.parametrize("shards", [2, 8])
def test_compressed_psum_matches_reference(shards):
    """Two rounds (the second carrying the first's error) over
    ``shards`` logical CPU shards against the reference under
    ``jax.vmap(axis_name="pod")``."""
    mesh = ShardMesh((torch.device("cpu"),) * shards)
    # op by op, as the port computes: jitted, XLA contracts the error's
    # g32 - q * scale into one fused multiply-add (a last-bit difference)
    ref = jax.vmap(lambda g, e: RCmp.compressed_psum(g, e, "pod"),
                   axis_name="pod")
    grads_np = [_tree(100 + s, dtypes=False) for s in range(shards)]
    to_np = lambda t: tree_map(lambda x: x[0], t)      # noqa: E731
    err = [init_error_state(_torch(g)) for g in grads_np]
    rerr = jax.tree.map(lambda *xs: jnp.stack(xs),
                        *[jax.tree.map(np.zeros_like, to_np(g))
                          for g in grads_np])
    for rnd in range(2):
        g_np = [tree_map(lambda x, r=rnd: (x[0] * (1 + r), x[1]), g)
                for g in grads_np]
        # each shard's payload: what it puts on the wire
        for s in range(shards):
            for name, g in tree_items(_torch(g_np[s])):
                e = dict(tree_items(err[s]))[name]
                q, sc = quantize_int8(g + e)
                rq, rsc = RCmp.quantize_int8(
                    jnp.asarray(g.numpy())
                    + jnp.asarray(np.asarray(dict(tree_items(rerr))[name][s])))
                np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
                assert float(sc) == float(rsc)
        means, err = compressed_psum([_torch(g) for g in g_np], err, mesh)
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                               *[to_np(g) for g in g_np])
        rmeans, rerr = ref(stacked, rerr)
        for s in range(shards):
            for name, m in tree_items(means[s]):
                want = np.asarray(dict(tree_items(rmeans))[name][s])
                np.testing.assert_allclose(m.numpy(), want, rtol=1e-6,
                                           atol=1e-6 * float(np.abs(
                                               want).max()))
                np.testing.assert_array_equal(
                    dict(tree_items(err[s]))[name].numpy(),
                    np.asarray(dict(tree_items(rerr))[name][s]))
                assert m.device == mesh.devices[s]
        # every shard holds the same mean
        for name, m in tree_items(means[0]):
            for s in range(1, shards):
                assert torch.equal(m, dict(tree_items(means[s]))[name])


def test_compressed_psum_checks_the_shard_count():
    mesh = ShardMesh((torch.device("cpu"),) * 2)
    g = {"w": torch.ones(3)}
    with pytest.raises(ValueError, match="2 shards"):
        compressed_psum([g], [init_error_state(g)], mesh)


def test_lr_is_a_device_tensor():
    lr = _lr(torch.tensor(3.0), AdamWConfig(schedule="constant"))
    assert isinstance(lr, torch.Tensor) and float(lr) == pytest.approx(3e-4)
    assert math.isclose(float(_lr(torch.tensor(0.0), AdamWConfig())), 0.0)
