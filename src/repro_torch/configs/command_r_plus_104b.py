"""command-r-plus-104b [hf:CohereForAI]: dense 64L d12288 96H(kv8),
d_ff 33792, vocab 256000, no-bias GQA."""
from repro_torch.models.config import AttnKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family=Family.DENSE,
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000, attn=AttnKind.GQA,
)

SMOKE_CONFIG = ModelConfig(
    name="command-r-smoke", family=Family.DENSE,
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, attn=AttnKind.GQA,
)

SKIP_SHAPES = {"long_500k"}
