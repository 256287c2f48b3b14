"""The port's sharding specs, hints, sharded step and elastic restore
against the JAX reference, on the CPU.

* Every ``spec_for`` leaf equals the reference's: the ten full configs'
  parameter trees (shapes only: the port's ``init_params(tp=16,
  device="meta")``, whose shapes are held to the reference's
  ``eval_shape``) on 16 x 16 and 2 x 16 x 16 through the reference's
  ``spec_for`` with a stand-in mesh (it reads only ``axis_names`` and
  ``devices.shape``); and the smoke configs' ``param_specs``,
  ``state_specs``, ``batch_specs`` and ``cache_specs`` on 2 x 2 and
  2 x 2 x 2 real JAX meshes (conftest forces 8 host devices).
* ``constrain`` returns its input itself; ``resolve`` drops an axis that
  does not divide its dim.
* ``place`` / ``gather`` bit for bit, each shard in its own storage;
  ``device_bytes`` from the specs equals the placed shards' bytes.
* The sharded train step on a logical CPU 2 x 2 mesh against the
  single-device step and the reference's jitted step (loss rel 2e-4,
  params rtol 2e-3 atol 2e-4: ``tests/test_distributed.py:70-75``), with
  2 microbatches too; then the elastic restore of the placed state onto
  2 x 1, exact.
* ``compressed_psum`` over a ``Mesh``'s ``data`` axis against the
  reference's ``shard_map`` case (2e-2).
* The production and test meshes: axes, DP axes, no card -> raises.
"""
import dataclasses
import tempfile
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import repro.configs as ref_configs
from repro.distributed import sharding as RSH
from repro.models import model as RM
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.train import steps as RS
from repro_torch import configs
from repro_torch.checkpoint.checkpoint import (restore_checkpoint,
                                               save_checkpoint)
from repro_torch.data.lm import SyntheticLM
from repro_torch.distributed import ctx
from repro_torch.distributed.sharding import (Mesh, NamedSharding, P,
                                              ShardedTensor, batch_specs,
                                              cache_specs, device_bytes,
                                              gather, param_specs, place,
                                              spec_for, state_specs)
from repro_torch.launch.mesh import (dp_axes, make_production_mesh,
                                     make_test_mesh)
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import compressed_psum, init_error_state
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.tree import tree_items

OPT = dict(lr_peak=1e-3)


class _StandIn:
    """What the reference's ``spec_for`` reads of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return JaxMesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _same_specs(got, want, what):
    """Two trees of shardings: every leaf's spec equal, as tuples."""
    g, w = dict(tree_items(got)), _flat_jax(want)
    assert sorted(g) == sorted(w), what
    for path, sh in g.items():
        assert tuple(sh.spec) == tuple(w[path].spec), (what, path, sh.spec,
                                                       w[path].spec)


def _flat_jax(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)] = leaf
    return out


@lru_cache(maxsize=None)
def _ref_shapes(arch, tp):
    cfg = ref_configs.get_config(arch)
    sds = jax.eval_shape(lambda k: RM.init_params(cfg, k, tp=tp),
                         jax.ShapeDtypeStruct((2,), jnp.uint32))
    return {k: tuple(v.shape) for k, v in _flat_jax(sds).items()}


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_full_config_specs_equal_reference(arch):
    params = M.init_params(configs.get_config(arch), device="meta", tp=16)
    shapes = {k: tuple(v.shape) for k, v in tree_items(params)}
    assert shapes == _ref_shapes(arch, 16)
    assert all(v.is_meta for _, v in tree_items(params))
    for shape, names in (((16, 16), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model"))):
        mine = Mesh.of("meta", shape, names)
        ref = _StandIn(shape, names)
        for path, leaf in shapes.items():
            got = spec_for(path, leaf, mine)
            want = RSH.spec_for(path, leaf, ref)
            assert tuple(got) == tuple(want), (arch, shape, path)


def _smoke_cache(rcfg, cfg):
    """The two packages' decode caches of a smoke config (B 8, S 64)."""
    enc = 16 if cfg.n_enc_layers else 0
    ref = jax.eval_shape(lambda: RM.init_decode_cache(rcfg, 8, 64,
                                                      enc_len=enc))
    return ref, M.init_decode_cache(cfg, 8, 64, "meta", enc_len=enc)


@pytest.mark.parametrize("shape,names", [((2, 2), ("data", "model")),
                                         ((2, 2, 2), ("pod", "data",
                                                      "model"))])
def test_smoke_specs_equal_reference_on_real_meshes(shape, names):
    jm, mine = _jax_mesh(shape, names), Mesh.of("cpu", shape, names)
    for arch in ref_configs.ARCH_IDS:
        rcfg, cfg = ref_configs.get_smoke_config(arch), \
            configs.get_smoke_config(arch)
        rp = jax.eval_shape(lambda k: RM.init_params(rcfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
        pp = M.init_params(cfg, device="meta")
        _same_specs(param_specs(pp, mine), RSH.param_specs(rp, jm), arch)
        rstate = jax.eval_shape(RS.init_train_state, rp)
        _same_specs(state_specs(init_train_state(pp), mine),
                    RSH.state_specs(rstate, jm), arch)
        rc, pc = _smoke_cache(rcfg, cfg)
        _same_specs(cache_specs(pc, mine), RSH.cache_specs(rc, jm), arch)
    for b in (8, 2, 1):
        rb = {"tokens": jax.ShapeDtypeStruct((b, 32), jnp.int32),
              "enc_embeds": jax.ShapeDtypeStruct((b, 32, 16), jnp.float32)}
        pb = {k: torch.empty(v.shape, device="meta") for k, v in rb.items()}
        _same_specs(batch_specs(pb, mine), RSH.batch_specs(rb, jm), b)


def test_constrain_returns_its_input_and_resolves_divisibility():
    mesh = Mesh.of("cpu", (2, 2), ("data", "model"))
    x = torch.zeros(4, 3, 8)
    assert ctx.constrain(x, "act") is x                  # no rules
    assert ctx.resolve(x, "act") is None
    with ctx.activation_rules(ctx.default_train_rules(mesh)):
        assert ctx.constrain(x, "act") is x
        # seq 3 does not divide over model: dropped, as the reference's
        assert tuple(ctx.resolve(x, "act").spec) == ("data", None, None)
        y = torch.zeros(4, 6, 8)
        assert tuple(ctx.resolve(y, "act").spec) == ("data", "model", None)
        assert ctx.current_rules() is not None
    assert ctx.current_rules() is None


def test_place_and_gather_are_exact_in_separate_storage():
    mesh = Mesh.of("cpu", (2, 2, 2), ("pod", "data", "model"))
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(8, 6, generator=gen),
            "b": torch.randn(4, 4, 2, generator=gen).to(torch.bfloat16),
            "c": torch.arange(5)}
    shs = {"a": NamedSharding(mesh, P(("pod", "data"), "model")),
           "b": NamedSharding(mesh, P("model", None, "data")),
           "c": NamedSharding(mesh, P())}
    placed = place(tree, shs)
    assert all(isinstance(v, ShardedTensor) for v in placed.values())
    ptrs = [t.data_ptr() for v in placed.values() for t in v.shards]
    assert len(set(ptrs)) == len(ptrs)
    assert placed["a"].shards[0].shape == (2, 3)
    back = gather(placed)
    for k in tree:
        assert back[k].dtype == tree[k].dtype
        assert torch.equal(back[k], tree[k]), k
    held = [sum(v.shards[i].numel() * v.shards[i].element_size()
                for v in placed.values()) for i in range(mesh.size)]
    assert device_bytes(tree, shs) == held


@lru_cache(maxsize=None)
def _reference_step():
    rcfg = dataclasses.replace(ref_configs.get_smoke_config("qwen3_0_6b"),
                               dtype="float32")
    params = jax.jit(RM.init_params, static_argnums=0)(
        rcfg, jax.random.PRNGKey(0))
    batch = SyntheticLM(rcfg.vocab_size, 32, 8, seed=0).batch_at(0)
    _, m = jax.jit(RS.make_train_step(rcfg, RefAdamWConfig(**OPT)))(
        RS.init_train_state(params), {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    return jax.tree.map(np.asarray, params), float(m["loss"]), batch


@pytest.mark.parametrize("microbatches", [1, 2])
def test_sharded_step_matches_single_device_and_reference(microbatches):
    params_np, ref_loss, batch = _reference_step()
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3_0_6b"),
                              dtype="float32")
    params = M.params_from_jax(params_np, "cpu")
    state = init_train_state(params)
    s1, m1 = make_train_step(cfg, AdamWConfig(**OPT),
                             microbatches=microbatches)(state, batch)
    mesh = make_test_mesh(2, 2, device="cpu")
    placed = place(state, state_specs(state, mesh))
    step = make_train_step(cfg, AdamWConfig(**OPT), microbatches=microbatches,
                           grad_shardings=param_specs(params, mesh))
    s2, m2 = step(placed, batch)
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    assert abs(l1 - l2) / abs(l1) < 2e-4, (l1, l2)
    if microbatches == 1:
        assert abs(ref_loss - l2) / abs(ref_loss) < 2e-4, (ref_loss, l2)
    assert int(m2["lr_step"]) == 1
    assert int(gather(s2["step"])) == 1
    for name, leaf in tree_items(s2["params"]):
        assert isinstance(leaf, ShardedTensor), name
    for (name, a), (_, c) in zip(tree_items(s1["params"]),
                                 tree_items(gather(s2["params"]))):
        np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=2e-3,
                                   atol=2e-4, err_msg=name)
    if microbatches == 2:
        return
    # elastic restore: saved from 2 x 2, restored onto 2 x 1, exact
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, s2, 1)
        mesh2 = make_test_mesh(2, 1, device="cpu")
        restored, step_no = restore_checkpoint(
            d, s2, shardings=state_specs(gather(s2), mesh2))
    assert step_no == 1
    for (name, a), (_, c) in zip(tree_items(gather(s2)),
                                 tree_items(gather(restored))):
        assert c.dtype == a.dtype and torch.equal(c, a), name
    for _, leaf in tree_items(restored):
        assert leaf.sharding.mesh is not s2["step"].sharding.mesh
        assert len(leaf.shards) == 2


def test_compressed_psum_over_mesh_axis_matches_shard_map():
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as JP
    from repro.optim.compression import compressed_psum as ref_psum
    from repro.optim.compression import init_error_state as ref_err
    rows = np.arange(32, dtype=np.float32).reshape(4, 8) / 7.3
    jm = _jax_mesh((4, 1), ("data", "model"))
    f = shard_map(lambda g, e: ref_psum(g, e, "data"), mesh=jm,
                  in_specs=(JP("data"), JP("data")),
                  out_specs=(JP("data"), JP("data")))
    g = {"w": jnp.asarray(rows)}
    want, _ = f(g, ref_err(g))
    mesh = make_test_mesh(4, 1, device="cpu")
    grads = [{"w": torch.from_numpy(rows[i:i + 1])} for i in range(4)]
    got, errs = compressed_psum(grads, [init_error_state(t) for t in grads],
                                mesh, "data")
    for i in range(4):
        np.testing.assert_allclose(got[i]["w"].numpy(),
                                   np.asarray(want["w"])[i:i + 1],
                                   rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(got[i]["w"].numpy(),
                                   rows.mean(0, keepdims=True),
                                   rtol=2e-2, atol=2e-2)
    assert len(errs) == 4


def test_meshes_axes_and_the_card_default():
    m = make_test_mesh(2, 2, pod=2, device="cpu")
    assert m.axis_names == ("pod", "data", "model")
    assert dp_axes(m) == ("pod", "data")
    assert dp_axes(make_test_mesh(device="cpu")) == ("data",)
    prod = make_production_mesh(multi_pod=True, device="meta")
    assert prod.shape == {"pod": 2, "data": 16, "model": 16}
    assert make_production_mesh(device="meta").size == 256
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_production_mesh()
