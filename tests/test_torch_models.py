"""The port's model layer against the JAX reference, on the CPU in float32.

* The configs: the ten archs, their full and smoke configs field by field,
  ``n_params``, ``skip_shapes`` and ``all_cells``.
* ``init_params``: the reference's tree (names, shapes, dtypes) from a
  seeded ``torch.Generator``; ``params_from_jax`` carries the reference's
  parameters across exactly, bfloat16 leaves included.
* ``mamba2_forward`` against the reference on ``mamba2_780m``'s smoke
  config, and against the port's own one-token recurrence.
* ``forward_hidden``, ``prefill`` and four ``decode_step``s (logits, SSM
  states and KV caches) against the reference on the smoke configs of
  ``zamba2_7b`` (hybrid), ``mamba2_780m`` (SSM), ``qwen3_0_6b`` (qk-norm,
  GQA), ``h2o_danube_3_4b`` (sliding window), ``qwen2_moe_a2_7b`` and
  ``deepseek_moe_16b`` (MoE), ``minicpm3_4b`` (MLA: its latent caches,
  the absorbed decode) and ``seamless_m4t_large_v2`` (encoder-decoder:
  the encoder from numpy-made stub embeddings; the decode's cross caches
  filled by ``cross_attention_kv`` from another such array, as the
  reference's ``tests/test_models.py:62-68`` does), parameters carried
  across by ``params_from_jax``.  Tolerance 1e-4 (absolute and relative):
  float32 sums in other orders over at most five layers; measured errors
  are under 1e-5.
* Prefill / teacher-forced decode consistency for the dense (GQA and MLA),
  hybrid and encoder-decoder families at the reference's bound (2e-4,
  ``tests/test_models.py:78``); the encoder-decoder's cross caches come
  from the encoder's own output.
* ``init_params`` and ``init_decode_cache`` of the MoE, MLA and
  encoder-decoder families build the reference's trees in the smoke
  configs' own bfloat16, and ``params_from_jax`` carries one tree of each
  across exactly.

Token ids and activations come from numpy seeds.
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
from repro.models.mamba2 import init_mamba2_layer as init_mamba2_layer_jax
from repro.models.mamba2 import mamba2_forward as mamba2_forward_jax
from repro.models.attention import cross_attention_kv as cross_kv_jax
from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.models.attention import cross_attention_kv
from repro_torch.models.mamba2 import (init_ssm_state, mamba2_decode_step,
                                       mamba2_forward)

ARCHS = ["zamba2_7b", "mamba2_780m", "qwen3_0_6b", "h2o_danube_3_4b",
         "qwen2_moe_a2_7b", "deepseek_moe_16b", "minicpm3_4b",
         "seamless_m4t_large_v2"]
# the families ROADMAP §1 item 2 brought in, one arch of each but MoE's two
NEW_FAMILIES = [("qwen2_moe_a2_7b", "moe"), ("deepseek_moe_16b", "moe"),
                ("seamless_m4t_large_v2", "encdec"), ("minicpm3_4b", "MLA")]
ENCDEC = "seamless_m4t_large_v2"
B, S, STEPS = 2, 64, 4
S_ENC = 48          # the encoder's stub frames (a length other than S)
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch):
    return (dataclasses.replace(ref_configs.get_smoke_config(arch),
                                dtype="float32"),
            dataclasses.replace(configs.get_smoke_config(arch),
                                dtype="float32"))


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# the reference's init, jitted (its eager vmapped init compiles every
# primitive on its own, several times slower)
_init_jax = jax.jit(RM.init_params, static_argnums=0)


def _enc_arrays(cfg):
    """The encoder-decoder's stub embeddings and the array its decode
    test's cross caches are projected from (None for the other
    families)."""
    if cfg.n_enc_layers == 0:
        return None, None
    rng = np.random.default_rng(11)
    return tuple(rng.standard_normal((B, S_ENC, cfg.d_model)).astype(
        np.float32) for _ in range(2))


@lru_cache(maxsize=None)
def _reference_run(arch):
    """The reference's parameters, hidden states, prefill logits and
    per-step decode logits and caches on the smoke config (jitted once
    per arch; shared by the tests below)."""
    rcfg, _ = _cfgs(arch)
    params = _init_jax(rcfg, jax.random.PRNGKey(0))
    toks = jnp.asarray(_tokens(rcfg, (B, S)))
    enc, cross_src = _enc_arrays(rcfg)
    enc = None if enc is None else jnp.asarray(enc)
    hidden, logits = jax.jit(lambda p, t, e: (
        RM.forward_hidden(p, rcfg, t, enc_embeds=e),
        RM.prefill(p, rcfg, t, enc_embeds=e)))(params, toks, enc)
    step = jax.jit(RM.decode_step, static_argnums=1)
    cache = RM.init_decode_cache(rcfg, B, 16,
                                 enc_len=0 if enc is None else S_ENC)
    if enc is not None:
        cache["cross_k"], cache["cross_v"] = jax.jit(jax.vmap(
            lambda p: cross_kv_jax(p["cross"], jnp.asarray(cross_src),
                                   rcfg, 1)))(params["layers"])
    steps = []
    for t in range(STEPS):
        out, cache = step(params, rcfg, toks[:, t], cache)
        steps.append(jax.tree.map(np.asarray, (out, cache)))
    return (jax.tree.map(np.asarray, params), np.asarray(toks),
            np.asarray(hidden), np.asarray(logits), steps)


def _port_cache(p, cfg, batch, max_len, cross_src=None):
    """The port's zero decode cache, an encoder-decoder's cross K/V
    projected from ``cross_src`` [B, S_enc, d] layer by layer."""
    if cross_src is None:
        return M.init_decode_cache(cfg, batch, max_len, device="cpu")
    cache = M.init_decode_cache(cfg, batch, max_len, device="cpu",
                                enc_len=cross_src.shape[1])
    for i in range(cfg.n_layers):
        ck, cv = cross_attention_kv(M._layer(p, i)["cross"], cross_src, cfg)
        cache["cross_k"][i], cache["cross_v"][i] = ck, cv
    return cache


# ------------------------------------------------------------------ configs
def test_configs_match_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    for arch in configs.ARCH_IDS:
        for get in ("get_config", "get_smoke_config"):
            ours = dataclasses.asdict(getattr(configs, get)(arch))
            theirs = dataclasses.asdict(getattr(ref_configs, get)(arch))
            assert {k: getattr(v, "value", v) for k, v in ours.items()} == \
                {k: getattr(v, "value", v) for k, v in theirs.items()}, arch
        assert configs.skip_shapes(arch) == ref_configs.skip_shapes(arch)
        assert configs.get_config(arch.replace("_", "-")) == \
            configs.get_config(arch)
    assert [(a, s.name) for a, s in configs.all_cells()] == \
        [(a, s.name) for a, s in ref_configs.all_cells()]


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_full_config_param_counts_match_reference(arch):
    cfg, ref = configs.get_config(arch), ref_configs.get_config(arch)
    assert cfg.n_params() == ref.n_params()
    assert cfg.n_active_params() == ref.n_active_params()
    assert (cfg.padded_vocab(), cfg.ssm_d_inner, cfg.ssm_n_heads) == \
        (ref.padded_vocab(), ref.ssm_d_inner, ref.ssm_n_heads)


def test_zamba2_7b_is_the_full_width_model():
    cfg = configs.get_config("zamba2_7b")
    assert cfg.n_params() == 6_747_267_072
    assert (cfg.ssm_d_inner, cfg.ssm_n_heads) == (7168, 112)
    assert M.hybrid_groups(cfg) == (13, 6, 3)


# --------------------------------------------------------------- parameters
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_reference_tree(arch):
    rcfg, cfg = _cfgs(arch)
    want = _leaves(jax.eval_shape(lambda: RM.init_params(
        rcfg, jax.random.PRNGKey(0))))
    got = _leaves(M.init_params(cfg, seed=3, device="cpu"))
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[name].shape), name
        assert str(leaf.dtype).split(".")[-1] == str(want[name].dtype), name
    again = _leaves(M.init_params(cfg, seed=3, device="cpu"))
    other = _leaves(M.init_params(cfg, seed=4, device="cpu"))
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert not torch.equal(got["/embed"], other["/embed"])


def test_init_params_laws():
    """Fan-in truncated normals within two standard deviations, per-layer
    draws independent, the reference's constant leaves."""
    cfg = dataclasses.replace(configs.get_smoke_config("zamba2_7b"),
                              dtype="float32")
    p = M.init_params(cfg, seed=0, device="cpu")
    w = p["layers"]["mixer"]["in_proj"]
    bound = 2.0 / np.sqrt(cfg.d_model)
    assert float(w.abs().max()) <= bound + 1e-6
    assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 0.88) < 0.05
    assert not torch.equal(w[0], w[1])
    mixer = p["layers"]["mixer"]
    nh = cfg.ssm_n_heads
    assert torch.allclose(mixer["A_log"][0],
                          torch.log(torch.linspace(1.0, 16.0, nh)))
    dt = torch.nn.functional.softplus(mixer["dt_bias"])
    assert float(dt.min()) >= 1e-3 - 1e-6 and float(dt.max()) <= 0.1 + 1e-6
    assert float(p["embed"].std()) < 0.02


def test_params_from_jax_is_exact_in_bfloat16():
    rcfg = ref_configs.get_smoke_config("zamba2_7b")       # bfloat16
    tree = jax.tree.map(np.asarray, _init_jax(rcfg, jax.random.PRNGKey(1)))
    p = M.params_from_jax(tree, "cpu")
    got, want = _leaves(p), _leaves(tree)
    for name, leaf in want.items():
        assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype), name
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      leaf.astype(np.float32))


# ------------------------------------------------------------------ mamba2
def test_mamba2_forward_matches_reference_and_recurrence():
    rcfg, cfg = _cfgs("mamba2_780m")
    p_ref = jax.jit(init_mamba2_layer_jax, static_argnums=(1, 2))(
        jax.random.PRNGKey(1), rcfg, jnp.float32)
    x = np.random.default_rng(2).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32) * 0.1
    want = np.asarray(jax.jit(mamba2_forward_jax, static_argnums=(2, 3))(
        p_ref, jnp.asarray(x), rcfg, False))
    p = M.params_from_jax(jax.tree.map(np.asarray, p_ref), "cpu")
    xt = torch.from_numpy(x)
    got = mamba2_forward(p, xt, cfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the chunked scan equals the one-token recurrence (test_models.py:93)
    st = init_ssm_state(cfg, 2, layers=1, device=torch.device("cpu"))
    st = {k: v[0] for k, v in st.items()}
    ys = []
    for t in range(64):
        y, st = mamba2_decode_step(p, xt[:, t:t + 1], st, cfg)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), got.numpy(),
                               atol=2e-4)


def test_mamba2_forward_needs_whole_chunks():
    _, cfg = _cfgs("mamba2_780m")
    p = M.init_params(cfg, device="cpu")["layers"]["mixer"]
    p = {k: v[0] for k, v in p.items()}
    with pytest.raises(ValueError, match="divisible by chunk"):
        mamba2_forward(p, torch.zeros((1, 48, cfg.d_model)), cfg)


# ------------------------------------------------------------- the models
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch):
    tree, toks, hidden, logits, _ = _reference_run(arch)
    _, cfg = _cfgs(arch)
    p = M.params_from_jax(tree, "cpu")
    t = torch.tensor(toks).long()
    enc, _ = _enc_arrays(cfg)
    kw = {} if enc is None else {"enc_embeds": torch.from_numpy(enc)}
    np.testing.assert_allclose(M.forward_hidden(p, cfg, t, **kw).numpy(),
                               hidden, **TOL)
    got = M.prefill(p, cfg, t, **kw)
    assert got.dtype == torch.float32 and got.shape == logits.shape
    np.testing.assert_allclose(got.numpy(), logits, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """Four greedy-free decode steps: logits (padded vocab masked), the
    length, and every SSM state and KV (or latent, or cross) cache after
    each step."""
    tree, toks, _, _, steps = _reference_run(arch)
    _, cfg = _cfgs(arch)
    p = M.params_from_jax(tree, "cpu")
    _, cross_src = _enc_arrays(cfg)
    cache = _port_cache(p, cfg, B, 16, None if cross_src is None
                        else torch.from_numpy(cross_src))
    for t, (want_logits, want_cache) in enumerate(steps):
        logits, cache = M.decode_step(p, cfg, torch.tensor(toks[:, t]).long(),
                                      cache)
        np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
        assert cache["len"].tolist() == want_cache["len"].tolist() == \
            [t + 1] * B
        got, want = _leaves(cache), _leaves(want_cache)
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_allclose(got[name].float().numpy(),
                                       want[name], **TOL, err_msg=name)


def test_decode_masks_the_padded_vocab():
    """Logits past ``vocab_size`` are -1e30 in decode (prefill leaves them,
    as the reference does)."""
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3_0_6b"),
                              vocab_size=500, dtype="float32")
    p = M.init_params(cfg, device="cpu")
    assert p["embed"].shape[0] == 512
    cache = M.init_decode_cache(cfg, 2, 4, device="cpu")
    logits, _ = M.decode_step(p, cfg, torch.tensor([1, 2]), cache)
    assert bool((logits[:, 500:] == -1e30).all())
    assert bool((logits[:, :500] > -1e29).all())
    pre = M.prefill(p, cfg, torch.tensor([[1], [2]]))
    assert bool((pre[:, 500:] > -1e29).all())


@pytest.mark.parametrize("arch,n", [("qwen3_0_6b", 12), ("zamba2_7b", 64),
                                    ("minicpm3_4b", 12), (ENCDEC, 12)])
def test_prefill_decode_consistency(arch, n):
    """Teacher-forced decode over a prompt reproduces prefill's last
    logits (the reference's bound, tests/test_models.py:78); the hybrid
    prompt spans two SSM chunks, MLA decodes in its absorbed form, and the
    encoder-decoder's decode attends to cross caches projected from the
    encoder's output."""
    _, cfg = _cfgs(arch)
    p = M.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, (1, n), seed=5)).long()
    enc = None
    if cfg.n_enc_layers:
        enc = torch.from_numpy(_enc_arrays(cfg)[0][:1])
    want = M.prefill(p, cfg, toks, enc_embeds=enc)
    cache = _port_cache(p, cfg, 1, n, None if enc is None
                        else M._encode(p, cfg, enc))
    for t in range(n):
        out, cache = M.decode_step(p, cfg, toks[:, t], cache)
    np.testing.assert_allclose(out[:, :cfg.vocab_size].numpy(),
                               want[:, :cfg.vocab_size].numpy(),
                               rtol=2e-4, atol=2e-4)


def _reference_cache(rcfg, batch, max_len, enc_len):
    return RM.init_decode_cache(rcfg, batch, max_len, enc_len=enc_len)


@pytest.mark.parametrize("arch,what", NEW_FAMILIES)
def test_families_left_out_name_their_item(arch, what):
    """The families item 2 brought in (the name is the test's from when
    they were refused): ``init_params`` and ``init_decode_cache`` of the
    MoE, MLA and encoder-decoder smoke configs, in their own bfloat16,
    build the reference's trees: the same names, shapes and dtypes (MLA's
    latent ``c_kv`` / ``k_rope``; the encoder stack, ``enc_norm``, cross
    blocks and cross caches)."""
    rcfg = ref_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    assert cfg.dtype == "bfloat16"
    enc_len = 6 if what == "encdec" else 0
    params = M.init_params(cfg, seed=0, device="cpu")
    for ours, theirs in (
            (params, jax.eval_shape(lambda: RM.init_params(
                rcfg, jax.random.PRNGKey(0)))),
            (M.init_decode_cache(cfg, 2, 4, device="cpu", enc_len=enc_len),
             jax.eval_shape(lambda: _reference_cache(rcfg, 2, 4, enc_len)))):
        got, want = _leaves(ours), _leaves(theirs)
        assert sorted(got) == sorted(want)
        for name, leaf in got.items():
            assert tuple(leaf.shape) == tuple(want[name].shape), name
            assert str(leaf.dtype).split(".")[-1] == str(want[name].dtype), \
                name
    family_leaf = {"moe": "/layers/mlp/router", "MLA": "/layers/attn/wkv_b",
                   "encdec": "/enc_layers/attn/wq"}[what]
    assert family_leaf in _leaves(params)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "minicpm3_4b", ENCDEC])
def test_params_from_jax_carries_new_families(arch):
    """One tree of each new family, in its bfloat16, carried across
    exactly (names, dtypes and values)."""
    rcfg = ref_configs.get_smoke_config(arch)
    tree = jax.tree.map(np.asarray, _init_jax(rcfg, jax.random.PRNGKey(2)))
    got, want = _leaves(M.params_from_jax(tree, "cpu")), _leaves(tree)
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype), name
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      leaf.astype(np.float32))
