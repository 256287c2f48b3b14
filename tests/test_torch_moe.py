"""The port's ``moe_ffn`` against the JAX reference's, on the CPU in float32.

The smoke configs of ``qwen2_moe_a2_7b`` (8 routed experts, top 2, a
shared expert of 128) and ``deepseek_moe_16b`` (8, top 3, a shared one
of 64), parameters carried across by ``params_from_jax``, inputs from
numpy seeds; the reference's ``moe_ffn`` runs jitted on the CPU, as its
own tests run it.  Four cases for each:

* ``plain``: one group a batch row, the capacity factor 1.25;
* ``drops``: capacity factor 0.25, so that queues overflow: the dropped
  choices are counted and must be many (the drop path is not vacuous);
* ``padded``: the reference's expert padding (its ``_init_moe`` at an
  expert-parallel degree of 16 pads 8 experts to 16): no token may reach
  a padded expert;
* ``ties``: inputs and router of small integers, so that the logits are
  exact integers and many tie; the port's choices must be the
  reference's (``jax.lax.top_k`` puts the lower index first).

Routing: the port's expert ids must equal the reference's top-k of its
own logits; a difference is allowed only where the reference's k-th and
(k+1)-th logits lie within 1e-5, and such places are counted.  Outputs at
1e-4 of the largest output (float32 sums in other orders).
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
from repro.models.layers import moe_ffn as moe_ffn_jax
from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.models.layers import moe_capacity, moe_ffn, moe_route

ARCHS = ["qwen2_moe_a2_7b", "deepseek_moe_16b"]
CASES = ["plain", "drops", "padded", "ties"]
B, S = 2, 64
NEAR_TIE = 1e-5

_moe_jax = jax.jit(moe_ffn_jax, static_argnums=2)
_init_moe_jax = jax.jit(RM._init_moe, static_argnums=(1, 2, 3))


def _cfgs(arch, case):
    extra = {"dtype": "float32"}
    if case == "drops":
        extra["capacity_factor"] = 0.25
    return (dataclasses.replace(ref_configs.get_smoke_config(arch), **extra),
            dataclasses.replace(configs.get_smoke_config(arch), **extra))


@lru_cache(maxsize=None)
def _case(arch, case):
    """(numpy parameters, x, the reference's output, its fp32 logits)."""
    rcfg, _ = _cfgs(arch, case)
    ep = 16 if case == "padded" else 1
    p = jax.tree.map(np.asarray, _init_moe_jax(jax.random.PRNGKey(3), rcfg,
                                               ep, jnp.float32))
    rng = np.random.default_rng(len(case) + len(arch))
    x = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    if case == "ties":
        # integers: every logit an exact integer, whatever the sum's order
        x = rng.integers(-1, 2, x.shape).astype(np.float32)
        p["router"] = rng.integers(-1, 2, p["router"].shape).astype(
            np.float32)
    want = np.asarray(_moe_jax(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                               rcfg))
    logits = np.array(jnp.einsum("bsd,de->bse", x, p["router"],
                                 preferred_element_type=jnp.float32))
    e = p["w_gate"].shape[0]
    if e > rcfg.n_experts:
        logits[..., rcfg.n_experts:] = -1e30
    return p, x, want, logits


def _reference_top_k(logits, k):
    vals, idx = jax.lax.top_k(jnp.asarray(logits), k + 1)
    return np.asarray(vals), np.asarray(idx)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, case):
    p_np, x, want, logits = _case(arch, case)
    rcfg, cfg = _cfgs(arch, case)
    p = M.params_from_jax(p_np, "cpu")
    xt = torch.from_numpy(x)
    got = moe_ffn(xt, p, cfg)
    route = moe_route(xt, p, cfg)
    k, e = cfg.top_k, p["w_gate"].shape[0]
    assert route.capacity == moe_capacity(cfg, S, e) == max(
        int(np.ceil(rcfg.capacity_factor * S * k / e)), 4)

    # routing: the reference's top-k of its own logits, near ties apart
    vals, ref_idx = _reference_top_k(logits, k)
    idx = route.idx.numpy()
    differ = (idx != ref_idx[..., :k]).any(-1)
    near = np.abs(vals[..., k - 1] - vals[..., k]) <= NEAR_TIE
    assert not (differ & ~near).any(), \
        f"{int((differ & ~near).sum())} tokens routed apart off a near tie " \
        f"({int(differ.sum())} apart, {int(near.sum())} near ties)"
    if case == "ties":
        ties = int((vals[..., :-1] == vals[..., 1:]).sum())
        assert ties > B * S // 4, f"only {ties} tied logits among the top k"
        assert not differ.any(), "ties resolved against the lower index"

    dropped = int((~route.keep).sum())
    if case == "drops":
        assert dropped >= B * S * k // 4, f"only {dropped} choices dropped"
        assert bool((route.gates[~route.keep] == 0).all())
    if case == "padded":
        assert e == 16 and cfg.n_experts == 8
        assert int(route.idx.max()) < cfg.n_experts, \
            "a token reached a padded expert"
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_route_queues_within_each_row(arch):
    """Each batch row routes alone: a kept choice's buffer row is its
    expert's, row's and queue position's, every kept row is taken once,
    and a row's routing does not move when the other row changes."""
    p_np, x, _, _ = _case(arch, "drops")
    _, cfg = _cfgs(arch, "drops")
    p = M.params_from_jax(p_np, "cpu")
    r = moe_route(torch.from_numpy(x), p, cfg)
    e, c = p["w_gate"].shape[0], r.capacity
    kept = r.dest[r.keep]
    assert kept.unique().numel() == kept.numel()
    assert bool((r.dest[~r.keep] == e * B * c).all())
    row = torch.arange(B)[:, None, None].expand_as(r.idx)
    assert torch.equal((r.dest[r.keep] // c) % B, row[r.keep])
    assert torch.equal(r.dest[r.keep] // (B * c), r.idx[r.keep])
    x2 = x.copy()
    x2[1] = np.random.default_rng(9).standard_normal(x2[1].shape)
    r2 = moe_route(torch.from_numpy(x2), p, cfg)
    assert torch.equal(r2.idx[0], r.idx[0]) and \
        torch.equal(r2.keep[0], r.keep[0])
