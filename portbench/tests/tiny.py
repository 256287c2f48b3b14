"""A benchmark tree at a size a CPU test can hold: the committed metric,
family and reference files beside a tiny configuration, mix and limits
written to a temporary directory, so the harness finds them by name as it
finds the real ones."""
from __future__ import annotations

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]

DEPLOYMENT = {"chips": 1, "page_tokens": 4, "pool_pages": 1024,
              "max_pages_per_seq": 48, "tenants": ["chat", "batchjob"],
              "manager_capacity": 256, "c_min": 8, "initial_blocks": 64,
              "window_events": 64}

DENSE = {"name": "tiny-dense", "model_type": "qwen3",
         "num_hidden_layers": 2, "hidden_size": 64,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
         "intermediate_size": 128, "vocab_size": 500, "rms_norm_eps": 1e-6,
         "rope_theta": 1000000, "tie_word_embeddings": True,
         "torch_dtype": "float32", "family": "gqa",
         "port": {"qk_norm": True},
         "assumed": {"embedding_std": 0.02},
         "deployment": DEPLOYMENT}

MOE = {"name": "tiny-moe", "model_type": "qwen2_moe",
       "num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
       "num_key_value_heads": 4, "intermediate_size": 128,
       "moe_intermediate_size": 32, "shared_expert_intermediate_size": 64,
       "num_experts": 8, "num_experts_per_tok": 2, "norm_topk_prob": True,
       "vocab_size": 500, "rms_norm_eps": 1e-6, "rope_theta": 1000000.0,
       "tie_word_embeddings": False, "torch_dtype": "float32",
       "family": "gqa", "port": {"qk_norm": False, "capacity_factor": 1.25},
       "assumed": {"embedding_std": 1.0},
       "deployment": DEPLOYMENT}

# every prompt its own, as in the benchmark's cells (see PERF.md: shared
# prefix pages are lost while in use)
MIX = {"driver": "serve_closed_loop", "clients": 6, "deck": 48,
       "block": 8, "deck_seed": 5,
       "tenants": [
           {"name": "chat", "share": 0.5, "system_prompts": 0,
            "system_tokens": 32,
            "prompt": {"dist": "log_uniform", "low": 8, "high": 40},
            "output": {"dist": "uniform", "low": 2, "high": 9}},
           {"name": "batchjob", "share": 0.5,
            "prompt": {"dist": "uniform", "low": 40, "high": 120},
            "output": {"dist": "uniform", "low": 2, "high": 6}}],
       "setup_rebalances": 2, "check_requests": 4}


def make_tree(tmp: pathlib.Path, limit: float = 1e-3, dtype="float32",
              configs=(DENSE, MOE), mix=MIX) -> pathlib.Path:
    """A checkout-like root under ``tmp`` holding ``BENCHMARK.json`` with
    one cell per configuration under the tiny mix (``<config>.tiny``)."""
    root = tmp / "tree"
    pb = root / "portbench"
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "families", "reference"):
        shutil.copytree(REPO / "portbench" / sub, pb / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"], spec["workloads"] = [], []
    for cfg in configs:
        cfg = dict(cfg, torch_dtype=dtype)
        f = f"portbench/configs/{cfg['name']}.json"
        (root / f).write_text(json.dumps(cfg))
        spec["configs"].append({"name": cfg["name"], "source": "test",
                                "file": f, "reduced": [], "why": "test"})
        name = f"{cfg['name']}.tiny"
        spec["workloads"].append({"name": name, "config": cfg["name"],
                                  "traffic": "tiny", "chips": 1,
                                  "why": "test"})
        (pb / "limits" / f"{name}.json").write_text(
            json.dumps({"logit_gap": limit}))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w["name"] for w in spec["workloads"]]
    (pb / "traffic" / "tiny.json").write_text(json.dumps(mix))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
