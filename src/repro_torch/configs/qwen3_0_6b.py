"""qwen3-0.6b [hf:Qwen/Qwen3 family]: dense 28L d1024 16H(kv8) head 128,
d_ff 3072, vocab 151936, qk-norm."""
from repro_torch.models.config import AttnKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family=Family.DENSE,
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936, attn=AttnKind.GQA, qk_norm=True,
    rope_theta=1e6, tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-smoke", family=Family.DENSE,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, attn=AttnKind.GQA, qk_norm=True,
    tie_embeddings=True,
)

SKIP_SHAPES = {"long_500k"}
