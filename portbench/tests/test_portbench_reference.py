"""The plain reference against the port at each model's smoke
configuration on the CPU, in fp32: the prefill's logits directly, and a
whole run's served tokens (prefill, decode through the pool's pages, the
MoE routing groups) through the harness's check."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from portbench.families.gqa import make_params, model_config
from portbench.reference.gqa import served_logits
from portbench.run import run_cell
from portbench.tests import tiny
from repro_torch.configs import get_smoke_config
from repro_torch.serve.engine import prefill_with_kv

ARCHS = ["qwen3_0_6b", "qwen2_moe_a2_7b"]


def _as_file(arch: str) -> dict:
    """The port's smoke configuration as a configuration file."""
    c = get_smoke_config(arch)
    out = {"name": c.name, "num_hidden_layers": c.n_layers,
           "hidden_size": c.d_model, "num_attention_heads": c.n_heads,
           "num_key_value_heads": c.n_kv_heads, "head_dim": c.head_dim,
           "intermediate_size": c.d_ff, "vocab_size": c.vocab_size,
           "rms_norm_eps": c.rms_eps, "rope_theta": c.rope_theta,
           "tie_word_embeddings": c.tie_embeddings, "torch_dtype": "float32",
           "family": "gqa",
           "port": {"qk_norm": c.qk_norm,
                    "capacity_factor": c.capacity_factor},
           "assumed": {"embedding_std": 1.0 if c.n_experts else 0.02},
           "deployment": tiny.DEPLOYMENT}
    if c.n_experts:
        out.update(num_experts=c.n_experts, num_experts_per_tok=c.top_k,
                   moe_intermediate_size=c.expert_d_ff,
                   shared_expert_intermediate_size=c.shared_d_ff)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_config_file_maps_to_the_smoke_config(arch):
    want = get_smoke_config(arch)
    got = model_config(_as_file(arch))
    keep = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
            "vocab_size", "qk_norm", "tie_embeddings", "n_experts", "top_k",
            "expert_d_ff", "shared_d_ff", "n_shared_experts", "family")
    assert {k: getattr(got, k) for k in keep} == {
        k: getattr(want, k) for k in keep}
    assert dataclasses.asdict(got)["dtype"] == "float32"


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_the_port(arch):
    cfg = _as_file(arch)
    params = make_params(cfg, 11, "cpu")
    rng = np.random.default_rng(0)
    page = 4
    prompts = [rng.integers(0, cfg["vocab_size"], n).astype(np.int32)
               for n in (13, 24, 37)]
    ref, _ = served_logits(params, cfg, [(p, [0]) for p in prompts], page)
    mcfg = model_config(cfg)
    for p, r in zip(prompts, ref):
        padded = np.pad(p, (0, -len(p) % page))
        got, _, _ = prefill_with_kv(params, mcfg,
                                    torch.as_tensor(padded[None]).long())
        got = got[0, :cfg["vocab_size"]]
        assert torch.allclose(got, r[0], atol=2e-5 * float(r.abs().max()),
                              rtol=0), float((got - r[0]).abs().max())


@pytest.mark.parametrize("arch", ARCHS)
def test_served_tokens_match_the_reference(arch, tmp_path):
    root = tiny.make_tree(tmp_path, configs=(_as_file(arch),), limit=1e-5)
    name = f"{get_smoke_config(arch).name}.tiny"
    out = run_cell(root, name, 2**35 + 3, 1.5, False, "cpu",
                   time.perf_counter())
    assert out["correct"], out["compared"]
    assert out["compared"]["logit_gap"]["value"] <= 1e-5
