"""The port's dry run, cost reader and roofline against the JAX reference
and closed forms, on the CPU.

* ``model_flops``, ``attention_flops`` and ``model_bytes`` equal the
  reference's for every cell, at 256 and 512 chips.
* ``analyze_step`` exact on closed forms (``tests/test_hlo_analysis.py``'s
  cases): a loop of L matmuls counts 2 M N K L, a nested 3 x 5 loop 15
  bodies, on the CPU and on ``meta``.
* A kernel-backed op (``prefill_attention``, ``mamba2_ssd_op``,
  ``paged_attention``) counts its formula's work, the same on ``meta`` and
  on the CPU, where the plain versions run; so does a whole smoke prefill.
  Their backwards count their backward formulas, the same on both, and so
  does a whole smoke train step (remat full and none).
* ``build_cell`` of every cell allocates no storage: every tensor it
  makes is a meta tensor.
* ``planned_moves`` equals ``analyze_step``'s count of the sharded train
  step's moves on a 2 x 2 mesh (1 and 2 microbatches), and of the FSDP
  gather for a prefill cell.
* ``run_cell``, ``main`` and ``render`` on a few smoke cells.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.launch import roofline as RR
from repro_torch import configs
from repro_torch.data.lm import SyntheticLM
from repro_torch.distributed.sharding import param_specs, place, state_specs
from repro_torch.kernels.flash_attention.ops import (
    prefill_attention, prefill_attention_backward_work,
    prefill_attention_work)
from repro_torch.kernels.mamba2_ssd.ops import (
    mamba2_ssd_backward_work, mamba2_ssd_op, mamba2_ssd_work)
from repro_torch.kernels.paged_attention.kernel import (paged_attention,
                                                        paged_attention_work)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.launch import dryrun, report, specs
from repro_torch.launch import roofline as R
from repro_torch.launch.cost_analysis import analyze_step
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import model as M
from repro_torch.models.config import SHAPES
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import init_train_state, make_train_step
from repro_torch.tree import tree_items


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_roofline_equals_reference_for_every_cell(arch):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    from repro.models.config import SHAPES as RSHAPES
    for name, shape in SHAPES.items():
        rs = RSHAPES[name]
        assert R.model_flops(cfg, shape) == RR.model_flops(rcfg, rs)
        for causal in (True, False):
            assert R.attention_flops(cfg, 2, shape.seq_len, shape.seq_len,
                                     causal) == RR.attention_flops(
                rcfg, 2, rs.seq_len, rs.seq_len, causal)
        for n in (256, 512):
            for remat, sp in (("full", True), ("none", False)):
                assert R.model_bytes(cfg, shape, n, remat=remat, sp=sp) == \
                    RR.model_bytes(rcfg, rs, n, remat=remat, sp=sp)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_of_matmuls_is_exact(device):
    m, n, k, L = 64, 96, 32, 10
    x = torch.randn(m, n).to(device)
    ws = torch.randn(L, k, n).to(device)
    one = torch.ones(n, k).to(device)

    def f(x, ws):
        c = x
        for w in ws:
            c = torch.einsum("mk,kn->mn", c @ one, w)
        return c
    cost = analyze_step(f, x, ws)
    assert cost.flops == (2 * m * n * k + 2 * m * k * n) * L
    assert cost.coll_total == 0.0 and cost.while_trip_counts == {}


def test_nested_loops_multiply():
    d, outer, inner = 32, 3, 5
    x, ws = torch.randn(d, d), torch.randn(inner, d, d)

    def f(x, ws):
        c = x
        for _ in range(outer):
            for w in ws:
                c = c @ w
        return c
    assert analyze_step(f, x, ws).flops == 2 * d ** 3 * outer * inner


def _attn_inputs(device, b=2, s=96, hq=4, hkv=2, d=16):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, generator=g) for h in (hq, hkv, hkv))
    return q.to(device), k.to(device), v.to(device)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_kernel_ops_count_the_same_on_meta_and_cpu(causal, window):
    counts = {}
    for device in ("cpu", "meta"):
        q, k, v = _attn_inputs(device)
        c = analyze_step(lambda: prefill_attention(q, k, v, causal=causal,
                                                   window=window))
        counts[device] = c
        assert c.flops == prefill_attention_work(q, k, v, causal,
                                                 window)[0]
        assert c.while_trip_counts == {"prefill_attention": 1}
    assert counts["cpu"].flops == counts["meta"].flops
    assert counts["cpu"].bytes == counts["meta"].bytes
    # the pairs of a causal 96 x 96 mask: 96 * 97 / 2
    if causal and not window:
        assert counts["cpu"].flops == 2 * 32 * 2 * 4 * 96 * 97 // 2
    ssd = {}
    for device in ("cpu", "meta"):
        g = torch.Generator().manual_seed(1)
        x = torch.randn(8, 128, 16, generator=g).to(device)
        bc = torch.randn(2, 128, 8, generator=g).to(device)
        da = -torch.rand(8, 128, generator=g).to(device)
        ssd[device] = analyze_step(lambda: mamba2_ssd_op(x, bc, bc, da,
                                                         chunk=32))
    assert ssd["cpu"].flops == ssd["meta"].flops == \
        mamba2_ssd_work(x, bc, 32)[0] > 0
    q = torch.randn(3, 4, 16)
    pages = torch.randn(10, 8, 2, 16)
    tables = torch.arange(9, dtype=torch.int32).reshape(3, 3)
    lens = torch.tensor([5, 17, 0], dtype=torch.int32)
    out = []
    c = analyze_step(lambda: out.append(paged_attention(q, pages, pages,
                                                         tables, lens)))
    assert c.flops == paged_attention_work(q, pages, lens)[0] == \
        4 * 16 * 4 * 22
    # the hook changes nothing the op computes
    assert torch.equal(out[0], paged_attention_ref(q, pages, pages, tables,
                                                   lens))


def test_smoke_prefill_counts_the_same_on_meta_and_cpu():
    for arch in ("qwen3_0_6b", "zamba2_7b", "minicpm3_4b"):
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  dtype="float32")
        out = {}
        for device in ("cpu", "meta"):
            params = M.init_params(cfg, device=device)
            toks = torch.zeros((2, 64), dtype=torch.int64, device=device)
            out[device] = analyze_step(M.prefill, params, cfg, toks)
        assert out["cpu"].flops == out["meta"].flops > 0, arch
        assert out["cpu"].while_trip_counts == out["meta"].while_trip_counts


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 40),
                                           (False, 0)])
def test_kernel_op_backwards_count_the_same_on_meta_and_cpu(causal, window):
    """Forward and backward of a kernel-backed op under autograd: each
    counted once by its formula, on ``meta`` as on the CPU (where the
    backward recomputes the plain version), nothing dispatched inside."""
    for device in ("cpu", "meta"):
        q, k, v = (t.requires_grad_() for t in _attn_inputs(device))

        def step():
            out = prefill_attention(q, k, v, causal=causal, window=window)
            torch.autograd.grad(out.sum(), (q, k, v))
        c = analyze_step(step)
        fwd = prefill_attention_work(q, k, v, causal, window)[0]
        bwd = prefill_attention_backward_work(q, k, v, causal, window)[0]
        assert c.flops == fwd + bwd, device
        assert bwd == 2 * (3 * 16 + 2 * 16) * fwd // (2 * (16 + 16))
        assert c.while_trip_counts == {"prefill_attention": 1,
                                       "prefill_attention.backward": 1}
    ssd = {}
    for device in ("cpu", "meta"):
        g = torch.Generator().manual_seed(1)
        x = torch.randn(8, 128, 16, generator=g).to(device).requires_grad_()
        bc = torch.randn(2, 128, 8, generator=g).to(device).requires_grad_()
        da = -torch.rand(8, 128, generator=g).to(device)

        def ssd_step():
            y = mamba2_ssd_op(x, bc, bc, da, chunk=32)
            torch.autograd.grad(y.sum(), (x, bc))
        ssd[device] = analyze_step(ssd_step)
        seg = torch.empty(8, 128, device=device)
        assert ssd[device].while_trip_counts == {"mamba2_ssd": 1,
                                                 "mamba2_ssd.backward": 1}
    want = mamba2_ssd_work(x, bc, 32)[0] + mamba2_ssd_backward_work(
        x, bc, bc, seg, chunk=32)[0]
    assert ssd["cpu"].flops == ssd["meta"].flops == want


@pytest.mark.parametrize("arch,remat", [("qwen3_0_6b", "full"),
                                        ("qwen3_0_6b", "none"),
                                        ("zamba2_7b", "full"),
                                        ("minicpm3_4b", "dots")])
def test_smoke_train_step_counts_the_same_on_meta_and_cpu(arch, remat):
    """A whole train step (loss, backward through the kernel-backed ops,
    AdamW): the cost reader's FLOPs and calls equal on ``meta`` and on the
    CPU, so a train cell's count does not depend on the device."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32", remat=remat)
    out = {}
    for device in ("cpu", "meta"):
        state = init_train_state(M.init_params(cfg, device=device))
        step = make_train_step(cfg, AdamWConfig())
        toks = torch.zeros((2, 64), dtype=torch.int32, device=device)
        out[device] = analyze_step(step, state, {"tokens": toks,
                                                 "labels": toks})
    assert out["cpu"].flops == out["meta"].flops > 0, arch
    assert out["cpu"].while_trip_counts == out["meta"].while_trip_counts
    assert any(k.endswith(".backward")
               for k in out["cpu"].while_trip_counts), arch


def test_build_cell_allocates_nothing():
    seen = 0
    for arch, shape in configs.all_cells():
        cell = specs.build_cell(arch, shape.name)
        for args in cell.args:
            for path, leaf in tree_items(args if isinstance(args, dict)
                                         else {"x": args}):
                assert leaf.is_meta, (arch, shape.name, path)
                seen += 1
        assert cell.kind == shape.kind
    assert seen > 0
    cell = specs.build_cell("qwen3_0_6b", "decode_32k", commit=False)
    assert cell.args[2]["kv"]["k"].shape == (28, 128, 32768, 8, 128)


def _smoke(monkeypatch):
    monkeypatch.setattr(specs, "get_config", lambda a: dataclasses.replace(
        configs.get_smoke_config(a), dtype="float32"))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_planned_moves_equal_the_sharded_steps(monkeypatch, microbatches):
    _smoke(monkeypatch)
    cfg = specs.get_config("qwen3_0_6b")
    params = M.init_params(cfg, device="cpu")
    state = init_train_state(params)
    mesh = make_test_mesh(2, 2, device="cpu")
    placed = place(state, state_specs(state, mesh))
    step = make_train_step(cfg, AdamWConfig(), microbatches=microbatches,
                           grad_shardings=param_specs(params, mesh))
    batch = SyntheticLM(cfg.vocab_size, 32, 8, seed=0).batch_at(0)
    cost = analyze_step(step, placed, batch)
    meta = specs.build_cell("qwen3_0_6b", "train_4k", tp=1,
                            microbatches=microbatches, global_batch=8)
    moves = dryrun.planned_moves(meta, mesh, microbatches)
    assert cost.collective_bytes == moves
    assert moves["all-gather"] == 2 * sum(
        t.numel() * t.element_size() for _, t in tree_items(params))


def test_run_cell_main_and_render(monkeypatch, tmp_path):
    _smoke(monkeypatch)
    path = str(tmp_path / "dryrun_torch.json")
    for arch, shape in (("qwen3_0_6b", "train_4k"),
                        ("zamba2_7b", "prefill_32k"),
                        ("minicpm3_4b", "decode_32k")):
        for mp in (False, True):
            rec = dryrun.run_cell(arch, shape, multi_pod=mp, verbose=False)
            assert rec["ok"] and rec["n_chips"] == (512 if mp else 256)
            pd = rec["per_device"]
            assert pd["arg_bytes"] > 0 and pd["temp_bytes"] is None
            assert pd["flops"] > 0 and rec["hbm_fit"]
            assert set(rec["roofline_s"]) == {"compute", "memory",
                                              "collective"}
            dryrun.append_result(rec, path)
    recs = dryrun.main(["--arch", "qwen3_0_6b", "--shape", "prefill_32k",
                        "--both-meshes", "--results", path])
    assert len(recs) == 2
    assert recs[0]["per_device"]["flops"] == \
        2 * recs[1]["per_device"]["flops"]
    with open(path) as f:
        assert len(json.load(f)) == 8
    table = report.render(path, "16x16")
    assert table.count("\n") == 1 + 4
    assert "| qwen3_0_6b | train_4k | train |" in table
    mesh = make_production_mesh(device="meta")
    assert np.all(mesh.devices == torch.device("meta"))
