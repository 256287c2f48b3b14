"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d2048 16H(kv16) MoE
4 shared + 60 routed top-4, expert d_ff 1408, vocab 151936."""
from repro_torch.models.config import AttnKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family=Family.MOE,
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=151936, attn=AttnKind.GQA,
    n_experts=60, n_shared_experts=4, top_k=4,
    expert_d_ff=1408, shared_d_ff=5632,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-moe-smoke", family=Family.MOE,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, attn=AttnKind.GQA,
    n_experts=8, n_shared_experts=2, top_k=2, expert_d_ff=64, shared_d_ff=128,
)

SKIP_SHAPES = {"long_500k"}  # pure full attention: no sub-quadratic path
