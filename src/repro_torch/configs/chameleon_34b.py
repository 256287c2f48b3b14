"""chameleon-34b [arXiv:2405.09818]: early-fusion VLM backbone, 48L d8192
64H(kv8) d_ff 22016, vocab 65536 (VQ image tokens live in-vocab).
The patch/VQ frontend is a stub per the brief: image tokens arrive as
ordinary vocab ids."""
from repro_torch.models.config import AttnKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family=Family.DENSE,
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=65536, attn=AttnKind.GQA, qk_norm=True,
)

SMOKE_CONFIG = ModelConfig(
    name="chameleon-smoke", family=Family.DENSE,
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, attn=AttnKind.GQA, qk_norm=True,
)

SKIP_SHAPES = {"long_500k"}
