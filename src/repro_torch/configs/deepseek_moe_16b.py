"""deepseek-moe-16b [arXiv:2401.06066]: 28L d2048 16H(kv16), fine-grained MoE
2 shared + 64 routed top-6, expert d_ff 1408, vocab 102400."""
from repro_torch.models.config import AttnKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family=Family.MOE,
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400, attn=AttnKind.GQA,
    n_experts=64, n_shared_experts=2, top_k=6,
    expert_d_ff=1408, shared_d_ff=2816,
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-moe-smoke", family=Family.MOE,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, attn=AttnKind.GQA,
    n_experts=8, n_shared_experts=1, top_k=3, expert_d_ff=64, shared_d_ff=64,
)

SKIP_SHAPES = {"long_500k"}
