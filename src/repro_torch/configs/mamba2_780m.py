"""mamba2-780m [arXiv:2405.21060]: pure SSD (state-space duality), 48L
d1536, attention-free, ssm_state 128, vocab 50280."""
from repro_torch.models.config import Family, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family=Family.SSM,
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    sub_quadratic=True, tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-smoke", family=Family.SSM,
    n_layers=3, d_model=64, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=512,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=32,
    sub_quadratic=True, tie_embeddings=True,
)

SKIP_SHAPES: set[str] = set()
