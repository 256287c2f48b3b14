"""The port's training path against the JAX reference, on the CPU.

* ``loss_fn`` and the gradient of every parameter leaf against
  ``jax.value_and_grad(RM.loss_fn)`` on the eight smoke configs of
  ``tests/test_torch_models.py`` in float32 (the encoder-decoder with
  numpy-made stub embeddings), parameters carried across by
  ``params_from_jax``: the loss at rel 1e-5, each leaf within 1e-4 of its
  largest |g| (float32 sums in other orders through at most five layers;
  measured under 5e-6).  The MoE configs route no token apart at these
  inputs (a flipped top-k would show as a leaf off by far more).
* ``chunked_cross_entropy``: S not a multiple of the chunk, labels of -1
  and a padded vocab, value and gradients against the reference's.
* ``remat="full"`` and ``"dots"`` give the loss and gradients of
  ``"none"`` bit for bit (``torch.equal``): the recompute repeats the
  same CPU operations on the same inputs.
* One ``make_train_step`` step on qwen3's smoke config (float32) against
  the reference's: parameters, ``opt`` and metrics to 1e-5; the
  microbatch equivalence of ``tests/test_train.py:40`` at its
  tolerances; one step of every arch's smoke config in its own bfloat16
  leaves finite parameters of the old dtypes (``tests/test_models.py:40``).
* ``SyntheticLM.batch_at`` equals the reference's, ``enc_embeds``
  included; ``PrefetchIterator`` hands out the stream in order.
* A checkpoint written by the reference restores into the port, and one
  written by the port into the reference, leaf for leaf.
* Restart determinism, failure injection and straggler detection
  (``tests/test_train.py:78-137``) through the port's ``Trainer``.
* The autograd Functions that carry the kernels' gradients, built with
  the plain forward in the kernel's place: gradients equal, bit for bit,
  to plain autograd's.
* The train launcher, ``--local --device cpu``.

Token ids and activations come from numpy seeds; each jitted reference
function is built once per config (``lru_cache``).
"""
import dataclasses
import os
import tempfile
import time
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.checkpoint import checkpoint as RC
from repro.data.lm import SyntheticLM as RefSyntheticLM
from repro.models import model as RM
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.train import steps as RS
from repro_torch import configs
from repro_torch.checkpoint.checkpoint import (latest_step,
                                               restore_checkpoint,
                                               save_checkpoint)
from repro_torch.data.lm import PrefetchIterator, SyntheticLM
from repro_torch.kernels.autograd import recompute_function
from repro_torch.kernels.flash_attention.ref import blockwise_attention
from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_chunked, seg_from_dA
from repro_torch.launch import train as train_launcher
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_items

ARCHS = ["zamba2_7b", "mamba2_780m", "qwen3_0_6b", "h2o_danube_3_4b",
         "qwen2_moe_a2_7b", "deepseek_moe_16b", "minicpm3_4b",
         "seamless_m4t_large_v2"]
B, S, S_ENC = 2, 64, 48
OPT = dict(lr_peak=1e-3, warmup_steps=5, total_steps=50)

_init_jax = jax.jit(RM.init_params, static_argnums=0)


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(ref_configs.get_smoke_config(arch),
                                dtype=dtype),
            dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype))


def _batch(cfg, b=B, s=S, seed=0):
    """Tokens, labels with a masked prefix, and the encoder-decoder's stub
    embeddings, as numpy arrays."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :5] = -1
    out = {"tokens": toks, "labels": labels}
    if cfg.n_enc_layers:
        out["enc_embeds"] = rng.standard_normal(
            (b, S_ENC, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree):
    """path -> leaf of a reference (JAX) or port tree."""
    if isinstance(tree, dict):
        return dict(tree_items(tree))
    raise TypeError(type(tree))


@lru_cache(maxsize=None)
def _reference_grads(arch):
    """(numpy parameters, the reference's loss, {path: gradient})."""
    rcfg, _ = _cfgs(arch)
    params = _init_jax(rcfg, jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(rcfg).items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, rcfg, b)))(params, batch)
    return (jax.tree.map(np.asarray, params), float(loss),
            {k: np.asarray(v) for k, v in _flat(grads).items()})


def _port_grads(arch, remat="none"):
    """(loss, {path: gradient}) of the port on the reference's
    parameters."""
    _, cfg = _cfgs(arch)
    cfg = dataclasses.replace(cfg, remat=remat)
    params = M.params_from_jax(_reference_grads(arch)[0], "cpu")
    paths, leaves = zip(*tree_items(params))
    for t in leaves:
        t.requires_grad_(True)
    loss = M.loss_fn(params, cfg, _torch_batch(_batch(cfg)))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(paths, grads))


def _hold_leaf(name, got, want, tol=1e-4):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale + 1e-12,
                               err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    _, want_loss, want = _reference_grads(arch)
    loss, got = _port_grads(arch)
    assert float(loss) == pytest.approx(want_loss, rel=1e-5)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        _hold_leaf(name, g.numpy(), want[name])


@pytest.mark.parametrize("mode", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_loss_and_grads(arch, mode):
    loss0, g0 = _port_grads(arch, "none")
    loss1, g1 = _port_grads(arch, mode)
    assert torch.equal(loss0, loss1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


@pytest.mark.parametrize("s,chunk", [(70, 32), (64, 512), (96, 32)])
def test_chunked_cross_entropy_matches_reference(s, chunk):
    """Value and gradients (h, head) against the reference's: S a
    multiple of the chunk or not, labels of -1, 9 padded vocab columns."""
    rng = np.random.default_rng(s)
    d, vp, vocab = 16, 41, 32
    h = rng.standard_normal((2, s, d)).astype(np.float32)
    head = rng.standard_normal((d, vp)).astype(np.float32)
    labels = rng.integers(0, vocab, (2, s)).astype(np.int32)
    labels[1, ::3] = -1
    want, (gh_want, gw_want) = jax.value_and_grad(
        lambda a, w: RM.chunked_cross_entropy(a, w, jnp.asarray(labels),
                                              vocab, chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(head))
    ht = torch.from_numpy(h).requires_grad_(True)
    wt = torch.from_numpy(head).requires_grad_(True)
    got = M.chunked_cross_entropy(ht, wt, torch.from_numpy(labels), vocab,
                                  chunk)
    gh, gw = torch.autograd.grad(got, (ht, wt))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(gh.numpy(), np.asarray(gh_want), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gw_want), rtol=1e-5,
                               atol=1e-7)
    # the padded columns take no probability and no gradient
    assert not gw[:, vocab:].any()
    with torch.no_grad():
        assert torch.equal(M.chunked_cross_entropy(
            ht, wt, torch.from_numpy(labels), vocab, chunk), got.detach())


def test_cross_entropy_of_all_masked_labels_is_zero():
    h = torch.randn(1, 8, 4)
    w = torch.randn(4, 10)
    assert float(M.chunked_cross_entropy(h, w, torch.full((1, 8), -1),
                                         10, 4)) == 0.0


@lru_cache(maxsize=None)
def _reference_step(dtype="float32"):
    """The reference's state before and after one step on qwen3's smoke
    config, its metrics, and the batch (numpy)."""
    rcfg, _ = _cfgs("qwen3_0_6b", dtype)
    params = _init_jax(rcfg, jax.random.PRNGKey(0))
    state = RS.init_train_state(params)
    batch = RefSyntheticLM(rcfg.vocab_size, 32, 8, seed=0).batch_at(0)
    step = jax.jit(RS.make_train_step(rcfg, RefAdamWConfig(**OPT)))
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    host = lambda t: jax.tree.map(np.asarray, t)        # noqa: E731
    return host(state), host(new), host(metrics), batch


def _port_state(ref_state):
    """The reference's numpy train state as the port's tensors."""
    return {"params": M.params_from_jax(ref_state["params"], "cpu"),
            "opt": {k: (M.params_from_jax(v, "cpu") if isinstance(v, dict)
                        else torch.from_numpy(np.array(v)))
                    for k, v in ref_state["opt"].items()},
            "step": torch.from_numpy(np.array(ref_state["step"]))}


def test_train_step_matches_reference():
    state0, want, want_m, batch = _reference_step()
    _, cfg = _cfgs("qwen3_0_6b")
    step = make_train_step(cfg, AdamWConfig(**OPT))
    got, metrics = step(_port_state(state0), batch)
    assert float(metrics["loss"]) == pytest.approx(float(want_m["loss"]),
                                                   rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(want_m["grad_norm"]), rel=1e-5)
    assert int(metrics["lr_step"]) == int(want_m["lr_step"]) == 1
    assert int(got["step"]) == int(want["step"]) == 1
    got_f, want_f = _flat(got), _flat(want)
    assert sorted(got_f) == sorted(want_f)
    for name, leaf in got_f.items():
        w = np.asarray(want_f[name])
        assert str(leaf.dtype).split(".")[-1] == str(w.dtype), name
        np.testing.assert_allclose(leaf.numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_microbatch_equivalence():
    """Gradient accumulation over 4 microbatches == one full batch
    (``tests/test_train.py:40``'s tolerances, the smoke config's bf16)."""
    cfg = configs.get_smoke_config("qwen3_0_6b")
    params = M.init_params(cfg, seed=0, device="cpu")
    b = SyntheticLM(cfg.vocab_size, 32, 8, seed=0).batch_at(0)
    s1, m1 = make_train_step(cfg, AdamWConfig(**OPT))(
        init_train_state(params), b)
    s4, m4 = make_train_step(cfg, AdamWConfig(**OPT), microbatches=4)(
        init_train_state(params), b)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-3)
    for name, a in _flat(s1["params"]).items():
        np.testing.assert_allclose(a.float().numpy(),
                                   _flat(s4["params"])[name].float().numpy(),
                                   rtol=5e-2, atol=5e-3, err_msg=name)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_smoke_train_step_finite_and_keeps_dtypes(arch):
    """One step of every arch's smoke config in its own dtype: finite
    loss, norm and parameters, each leaf of its old dtype
    (``tests/test_models.py:40``)."""
    cfg = configs.get_smoke_config(arch)
    params = M.init_params(cfg, seed=0, device="cpu")
    enc = cfg.d_model if cfg.n_enc_layers else None
    batch = SyntheticLM(cfg.vocab_size, 16, 2, seed=1, enc_dim=enc,
                        enc_len=16).batch_at(0)
    state, m = make_train_step(cfg, AdamWConfig(lr_peak=1e-3))(
        init_train_state(params), batch)
    assert np.isfinite(float(m["loss"])) and 0 < float(m["loss"]) < 20
    assert np.isfinite(float(m["grad_norm"]))
    for (name, new), (_, old) in zip(tree_items(state["params"]),
                                     tree_items(params)):
        assert new.dtype == old.dtype and not new.requires_grad, name
        assert bool(torch.isfinite(new.float()).all()), name


def test_loss_decreases():
    """``tests/test_train.py:31``: 15 steps on the smoke qwen3."""
    cfg = configs.get_smoke_config("qwen3_0_6b")
    state = init_train_state(M.init_params(cfg, seed=0, device="cpu"))
    step = make_train_step(cfg, AdamWConfig(**OPT))
    data = SyntheticLM(cfg.vocab_size, 32, 8, seed=0)
    losses = []
    for i in range(15):
        state, m = step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("enc", [None, 24])
def test_synthetic_lm_matches_reference(enc):
    ours = SyntheticLM(1000, 16, 4, seed=5, enc_dim=enc, enc_len=12)
    theirs = RefSyntheticLM(1000, 16, 4, seed=5, enc_dim=enc, enc_len=12)
    for step in (0, 3, 17):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    it = PrefetchIterator(ours, start_step=2, prefetch=2)
    try:
        for step in (2, 3, 4):
            np.testing.assert_array_equal(next(it)["tokens"],
                                          ours.batch_at(step)["tokens"])
    finally:
        it.close()


def _state_pair(dtype):
    """The reference's train state on qwen3's smoke config and the port's
    of the same tree (other values: a fresh init of seed 1)."""
    rcfg, cfg = _cfgs("qwen3_0_6b", dtype)
    ref = RS.init_train_state(_init_jax(rcfg, jax.random.PRNGKey(0)))
    ref = dict(ref, step=jnp.asarray(7, jnp.int32))
    port = init_train_state(M.init_params(cfg, seed=1, device="cpu"))
    return ref, port


def _host32(leaf):
    """A leaf as numpy, floating leaves widened to float32 (exact)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.float().numpy() if leaf.is_floating_point() \
            else leaf.numpy()
    a = np.asarray(leaf)
    return a.astype(np.float32) if a.dtype.kind == "f" or \
        a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_packages(dtype):
    """The reference writes, the port restores into its own tree (each
    leaf on its like-leaf's device and dtype), and the other way round:
    every leaf equal."""
    ref, port = _state_pair(dtype)
    with tempfile.TemporaryDirectory() as d:
        RC.save_checkpoint(d, ref, 7)
        assert latest_step(d) == 7
        got, step = restore_checkpoint(d, port)
        assert step == 7
        want, like = _flat(ref), _flat(port)
        assert sorted(_flat(got)) == sorted(want)
        for name, leaf in tree_items(got):
            assert (leaf.dtype, leaf.device) == (like[name].dtype,
                                                 like[name].device), name
            np.testing.assert_array_equal(_host32(leaf),
                                          _host32(want[name]), err_msg=name)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, port, 3)
        assert RC.latest_step(d) == 3
        back, step = RC.restore_checkpoint(d, ref)
        assert step == 3
        back, ref_f = _flat(back), _flat(ref)
        for name, leaf in tree_items(port):
            assert np.asarray(back[name]).dtype == np.asarray(
                ref_f[name]).dtype, name
            np.testing.assert_array_equal(_host32(back[name]),
                                          _host32(leaf), err_msg=name)


def _setup(seq, batch, seed):
    cfg = configs.get_smoke_config("qwen3_0_6b")
    state = init_train_state(M.init_params(cfg, seed=0, device="cpu"))
    return (cfg, state, make_train_step(cfg, AdamWConfig(**OPT)),
            SyntheticLM(cfg.vocab_size, seq, batch, seed=seed))


def test_checkpoint_roundtrip_and_restart_determinism():
    cfg, state, step, data = _setup(32, 8, 2)
    with tempfile.TemporaryDirectory() as d:
        for i in range(5):
            state, _ = step(state, data.batch_at(i))
        save_checkpoint(d, state, 5)
        ref_state = state
        for i in range(5, 8):
            ref_state, ref_m = step(ref_state, data.batch_at(i))
        restored, s = restore_checkpoint(d, state)
        assert s == 5
        for i in range(5, 8):
            restored, m = step(restored, data.batch_at(i))
        assert float(m["loss"]) == pytest.approx(float(ref_m["loss"]),
                                                 rel=1e-5)


def test_trainer_failure_injection_and_recovery():
    cfg, state, step, data = _setup(32, 8, 3)
    fails = {"n": 0}

    def hook(step_i):
        if step_i == 7 and fails["n"] == 0:
            fails["n"] += 1
            raise RuntimeError("injected")

    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(step, state, data,
                     TrainerConfig(total_steps=12, ckpt_every=3, ckpt_dir=d),
                     failure_hook=hook)
        out = tr.run()
        assert sorted(os.listdir(d)) == sorted(
            f"step_{k}.{ext}" for k in (3, 6, 9, 12) for ext in ("json",
                                                                 "npz"))
    assert out["restarts"] == 1 and out["final_step"] == 12
    assert tr.failures == ["step 7: RuntimeError('injected')"]
    # steps 6 and 7 ran again from the step-6 checkpoint
    assert [m["step"] for m in tr.metrics_log] == list(range(7)) + \
        list(range(6, 12))


def test_trainer_straggler_detection():
    cfg, state, step, data = _setup(16, 4, 4)
    hits = []

    def slow_hook(step_i):
        if step_i == 9:
            time.sleep(4.0)         # >> straggler_factor x median step

    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(step, state, data,
                     TrainerConfig(total_steps=11, ckpt_every=100,
                                   ckpt_dir=d, straggler_factor=2.0),
                     failure_hook=slow_hook,
                     straggler_hook=lambda s, f: hits.append((s, f)))
        tr.run()
    assert [s for s, _ in hits] == [9] and tr.straggler_steps == 1
    assert hits[0][1] > 2.0


def test_trainer_gives_up_past_max_restarts():
    cfg, state, step, data = _setup(16, 2, 5)

    def always(step_i):
        raise RuntimeError("node lost")

    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(step, state, data,
                     TrainerConfig(total_steps=3, ckpt_dir=d,
                                   max_restarts=2), failure_hook=always)
        with pytest.raises(RuntimeError, match="node lost"):
            tr.run()
    assert tr.restarts == 3


def _grads_of(fn, inputs, upstream):
    xs = [x.clone().requires_grad_(True) for x in inputs]
    out = fn(*xs)
    return out, torch.autograd.grad(out, xs, upstream)


@pytest.mark.parametrize("case", [(2, 96, 4, 2, 16, 16, True, 0),
                                  (1, 70, 2, 2, 16, 8, True, 24),
                                  (2, 40, 4, 1, 8, 8, False, 0)])
def test_attention_function_gradients_equal_plain_autograd(case):
    """``recompute_function`` with the plain forward in the kernel's
    place: its output and gradients equal plain autograd's bit for bit
    (the backward is the plain version's own)."""
    b, s, hq, hkv, d, dv, causal, window = case
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, dv)))
    up = torch.from_numpy(rng.standard_normal((b, s, hq, dv)).astype(
        np.float32))
    static = dict(causal=causal, window=window, block_q=32, block_kv=32)
    fn = recompute_function(blockwise_attention, blockwise_attention, "Fa")
    out, got = _grads_of(lambda *t: fn.apply(static, *t), (q, k, v), up)
    want_out, want = _grads_of(
        lambda *t: blockwise_attention(*t, **static), (q, k, v), up)
    assert torch.equal(out, want_out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", [(4, 64, 16, 8, 16, 2), (3, 96, 8, 4, 32, 1)])
def test_ssd_function_gradients_equal_plain_autograd(case):
    bh, s, p, n, chunk, g = case
    rng = np.random.default_rng(bh + s)
    x = torch.from_numpy(rng.standard_normal((bh, s, p)).astype(np.float32))
    Bm, Cm = (torch.from_numpy(rng.standard_normal((g, s, n)).astype(
        np.float32)) for _ in range(2))
    seg = seg_from_dA(-torch.from_numpy(rng.random((bh, s)).astype(
        np.float32)) * 0.5, chunk)
    up = torch.from_numpy(rng.standard_normal((bh, s, p)).astype(np.float32))
    fn = recompute_function(mamba2_ssd_chunked, mamba2_ssd_chunked, "Ssd")
    out, got = _grads_of(lambda *t: fn.apply(dict(chunk=chunk), *t),
                         (x, Bm, Cm, seg), up)
    want_out, want = _grads_of(
        lambda *t: mamba2_ssd_chunked(*t, chunk=chunk), (x, Bm, Cm, seg), up)
    assert torch.equal(out, want_out)
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)


def test_function_saves_nothing_under_no_grad():
    """Under ``torch.no_grad()`` the Function's output carries no node."""
    fn = recompute_function(mamba2_ssd_chunked, mamba2_ssd_chunked, "Ssd")
    x = torch.randn(2, 32, 16, requires_grad=True)
    B_ = torch.randn(1, 32, 4)
    seg = seg_from_dA(-torch.rand(2, 32), 16)
    with torch.no_grad():
        out = fn.apply(dict(chunk=16), x, B_, B_, seg)
    assert out.grad_fn is None and not out.requires_grad


def test_train_launcher_local_on_cpu(tmp_path, capsys):
    out = train_launcher.main(["--arch", "qwen3_0_6b", "--local",
                               "--steps", "3", "--device", "cpu",
                               "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 3 and out["restarts"] == 0
    assert np.isfinite(out["final_loss"])
    assert "device=cpu" in capsys.readouterr().out
