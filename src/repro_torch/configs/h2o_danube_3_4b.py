"""h2o-danube-3-4b [arXiv:2401.16818]: dense 24L d3840 32H(kv8, head 120),
d_ff 10240, vocab 32000, llama+mistral mix with sliding-window attention
(window 4096) -> KV bounded by the window, so long_500k decode runs."""
from repro_torch.models.config import AttnKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family=Family.DENSE,
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
    d_ff=10240, vocab_size=32000, attn=AttnKind.SWA, window=4096,
    sub_quadratic=True,
)

SMOKE_CONFIG = ModelConfig(
    name="h2o-danube-smoke", family=Family.DENSE,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, attn=AttnKind.SWA, window=32,
    sub_quadratic=True,
)

SKIP_SHAPES: set[str] = set()
