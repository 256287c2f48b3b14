"""minicpm3-4b [hf:openbmb/MiniCPM3-4B]: dense 62L d2560 40H with MLA
(q_lora 768, kv_lora 256, nope 64 + rope 32, v 64), d_ff 6400, vocab 73448.
40 q-heads are padded to 48 for 16-way TP (padding masked)."""
from repro_torch.models.config import AttnKind, Family, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family=Family.DENSE,
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=96,
    d_ff=6400, vocab_size=73448, attn=AttnKind.MLA,
    q_lora_rank=768, kv_lora_rank=256,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
)

SMOKE_CONFIG = ModelConfig(
    name="minicpm3-smoke", family=Family.DENSE,
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
    d_ff=128, vocab_size=512, attn=AttnKind.MLA,
    q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16,
)

SKIP_SHAPES = {"long_500k"}
