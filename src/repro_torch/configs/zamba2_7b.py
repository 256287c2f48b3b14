"""zamba2-7b [arXiv:2411.15242]: hybrid — 81 Mamba2 layers + one SHARED
attention+FFN block applied every 6 layers (weights shared across all
applications). d3584, attn 32H(kv32, head 112), d_ff 14336, ssm_state 64."""
from repro_torch.models.config import AttnKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family=Family.HYBRID,
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000, attn=AttnKind.GQA,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, attn_every=6,
    sub_quadratic=True,
)

SMOKE_CONFIG = ModelConfig(
    name="zamba2-smoke", family=Family.HYBRID,
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, attn=AttnKind.GQA,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=32, attn_every=2,
    sub_quadratic=True,
)

SKIP_SHAPES: set[str] = set()
