"""The port's split-KV decode and tensor-parallel trees against the JAX
reference, on the CPU.

* ``decode_step(commit=False)`` against the reference's, for the smoke
  config of every family with attention (GQA, sliding window, MLA, MoE,
  the hybrid's shared attention, the encoder-decoder's self attention),
  in float32, from the same seeded caches (K/V or latents, SSM states,
  cross K/V) and lengths (past the sliding window too): logits within
  1e-5 of max |logit|, the stacked 1-token deltas within 1e-6 of max
  |delta|, SSM states within 1e-5.
* ``commit=False`` against the port's ``commit=True`` from the same
  cache: logits within 1e-5 of max |logit|; the deltas equal to what
  ``commit=True`` wrote (layer 0 bit for bit; deeper layers within 1e-5,
  their inputs having passed through the two paths' different float
  orders); the frozen cache untouched bit for bit and ``len`` left alone.
  Sliding-window lengths stay inside the window here: past it the
  reference's frozen path sees one key more than its commit path
  (``src/repro/models/attention.py:346-347`` against ``:320-321``), and
  the port keeps both.
* ``init_params(tp=16)`` trees shaped as the reference's (q heads padded,
  MoE experts padded and masked), and prefill and split-KV decode logits
  at ``tp=16`` through ``params_from_jax`` within 1e-5.
"""
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import model as RM
from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.tree import tree_items

ARCHS = ["qwen3_0_6b", "h2o_danube_3_4b", "minicpm3_4b", "qwen2_moe_a2_7b",
         "zamba2_7b", "seamless_m4t_large_v2"]
B, SMAX, ENC = 3, 48, 12

_init_jax = jax.jit(RM.init_params, static_argnums=(0, 2))


def _cfgs(arch):
    return (dataclasses.replace(ref_configs.get_smoke_config(arch),
                                dtype="float32"),
            dataclasses.replace(configs.get_smoke_config(arch),
                                dtype="float32"))


@lru_cache(maxsize=None)
def _params(arch, tp=1):
    rcfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, _init_jax(rcfg, jax.random.PRNGKey(0),
                                              tp))


def _cache_np(cfg, lens, seed=0):
    """Seeded values for every cache leaf the port's init makes."""
    rng = np.random.default_rng(seed)
    shapes = M.init_decode_cache(cfg, B, SMAX, "meta", enc_len=ENC)
    out = {}
    for path, t in tree_items(shapes):
        if path == "len":
            out[path] = np.asarray(lens, np.int32)
        elif path == "enc_len":
            out[path] = np.full(B, ENC, np.int32)
        else:
            scale = 0.1 if path.startswith("ssm") else 1.0
            out[path] = (rng.standard_normal(t.shape) * scale
                         ).astype(np.float32)
    return out


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _port_cache(flat):
    return _nest({k: torch.from_numpy(v.copy()) for k, v in flat.items()})


@lru_cache(maxsize=None)
def _ref_decode(arch, commit, tp=1):
    rcfg, _ = _cfgs(arch)
    return jax.jit(lambda p, t, c: RM.decode_step(p, rcfg, t, c, tp,
                                                  commit=commit))


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _lens(cfg, inside_window):
    hi = min(SMAX - 1, cfg.window - 1) if (inside_window and cfg.window) \
        else SMAX - 1
    return [hi, hi // 2, 1]


def _close(got, want, tol, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale + 1e-12,
                               err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_kv_matches_reference(arch):
    rcfg, cfg = _cfgs(arch)
    flat = _cache_np(cfg, _lens(cfg, inside_window=False))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, B) \
        .astype(np.int32)
    want_l, want_c = _ref_decode(arch, False)(
        _params(arch), jnp.asarray(toks), jax.tree.map(jnp.asarray,
                                                       _nest(flat)))
    got_l, got_c = M.decode_step(M.params_from_jax(_params(arch), "cpu"),
                                 cfg, torch.from_numpy(toks),
                                 _port_cache(flat), commit=False)
    v = cfg.vocab_size
    _close(got_l.numpy()[:, :v], np.asarray(want_l)[:, :v], 1e-5, "logits")
    want_f, got_f = _flat(want_c), dict(tree_items(got_c))
    assert sorted(want_f) == sorted(got_f)
    for path, w in want_f.items():
        g = got_f[path].numpy()
        assert g.shape == w.shape, (path, g.shape, w.shape)
        if path.startswith("kv/"):
            assert g.shape[2] == 1
            _close(g, w, 1e-6, path)
        elif path.startswith("ssm/"):
            _close(g, w, 1e-5, path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_kv_matches_commit_and_leaves_the_cache(arch):
    _, cfg = _cfgs(arch)
    lens = _lens(cfg, inside_window=True)
    flat = _cache_np(cfg, lens, seed=2)
    params = M.params_from_jax(_params(arch), "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, B).astype(np.int32))
    frozen = _port_cache(flat)
    lf, split = M.decode_step(params, cfg, toks, frozen, commit=False)
    for path, t in tree_items(frozen):
        if not path.startswith("ssm/"):          # SSM states update
            assert torch.equal(t, torch.from_numpy(flat[path])), path
    assert torch.equal(split["len"], frozen["len"])
    lt, committed = M.decode_step(params, cfg, toks, _port_cache(flat),
                                  commit=True)
    assert torch.equal(committed["len"], frozen["len"] + 1)
    v = cfg.vocab_size
    _close(lf.numpy()[:, :v], lt.numpy()[:, :v], 1e-5, "logits")
    rows = torch.arange(B)
    at = torch.as_tensor(lens)
    for name, delta in split.get("kv", {}).items():
        wrote = committed["kv"][name][:, rows, at]          # [L, B, ...]
        assert torch.equal(wrote[0], delta[0, :, 0]), name
        _close(delta[:, :, 0].numpy(), wrote.numpy(), 1e-5, name)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_tp16_trees_shaped_as_reference(arch):
    rcfg = ref_configs.get_smoke_config(arch)
    want = jax.eval_shape(lambda k: RM.init_params(rcfg, k, tp=16),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat_sds(want)}
    got = {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
           for k, t in tree_items(M.init_params(configs.get_smoke_config(
               arch), device="cpu", tp=16))}
    assert got == want


def _flat_sds(tree):
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield "/".join(str(getattr(p, "key", p)) for p in path), v


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "minicpm3_4b",
                                  "qwen2_moe_a2_7b"])
def test_tp16_prefill_and_split_kv_match_reference(arch):
    rcfg, cfg = _cfgs(arch)
    tree = _params(arch, 16)
    params = M.params_from_jax(tree, "cpu")
    if cfg.n_experts:
        assert params["layers"]["mlp"]["w_gate"].shape[1] == \
            cfg.padded_experts(16) > cfg.n_experts
    else:
        assert params["layers"]["attn"]["wo"].shape[1] == \
            cfg.padded_heads(16) * cfg.v_dim > cfg.n_heads * cfg.v_dim
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 24)) \
        .astype(np.int32)
    want = jax.jit(lambda p, t: RM.prefill(p, rcfg, t, 16))(
        tree, jnp.asarray(toks))
    got = M.prefill(params, cfg, torch.from_numpy(toks), 16)
    v = cfg.vocab_size
    _close(got.numpy()[:, :v], np.asarray(want)[:, :v], 1e-5, "prefill")
    flat = _cache_np(cfg, _lens(cfg, inside_window=False), seed=5)
    step_toks = np.resize(toks[:, 0], B)
    want_l, _ = _ref_decode(arch, False, 16)(
        tree, jnp.asarray(step_toks), jax.tree.map(jnp.asarray, _nest(flat)))
    got_l, _ = M.decode_step(params, cfg, torch.from_numpy(step_toks),
                             _port_cache(flat), 16, commit=False)
    _close(got_l.numpy()[:, :v], np.asarray(want_l)[:, :v], 1e-5, "decode")
