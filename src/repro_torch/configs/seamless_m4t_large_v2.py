"""seamless-m4t-large-v2 [arXiv:2308.11596]: enc-dec, 24 encoder + 24
decoder layers, d1024 16H(kv16, head 64), d_ff 8192, vocab 256206.
The speech frontend is a stub per the brief: the encoder consumes
precomputed frame embeddings [B, S_enc, d]."""
from repro_torch.models.config import AttnKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family=Family.ENCDEC,
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=8192, vocab_size=256206, attn=AttnKind.GQA,
    frontend_stub=True,
)

SMOKE_CONFIG = ModelConfig(
    name="seamless-smoke", family=Family.ENCDEC,
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=512, attn=AttnKind.GQA,
    frontend_stub=True,
)

SKIP_SHAPES = {"long_500k"}
