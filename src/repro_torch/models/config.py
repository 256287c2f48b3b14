"""Model configuration for every assigned architecture family.

The port's own copy of the reference's ``repro.models.config`` (data
only, no JAX): one ``ModelConfig`` describes dense / MoE / SSM / hybrid /
enc-dec LMs with the attention flavours the pool requires (GQA, MLA, SWA,
qk-norm).  Derived fields keep the reference's padding (vocab to x256,
MoE experts to the expert-parallel degree, q heads to the TP degree), so
parameter shapes and counts are the reference's.
"""
from __future__ import annotations

import dataclasses
import enum

__all__ = ["AttnKind", "Family", "ModelConfig", "ShapeConfig", "SHAPES"]


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    ENCDEC = "encdec"


class AttnKind(str, enum.Enum):
    GQA = "gqa"          # grouped-query (covers MHA when n_kv == n_heads)
    MLA = "mla"          # multi-head latent attention (DeepSeek/MiniCPM3)
    SWA = "swa"          # sliding-window GQA (Mistral-style)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention flavour
    attn: AttnKind = AttnKind.GQA
    window: int = 0                  # SWA window (0 = full)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    causal: bool = True

    # MoE
    n_experts: int = 0               # routed experts (0 = dense FFN)
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0             # per-expert hidden (fine-grained MoE)
    shared_d_ff: int = 0
    capacity_factor: float = 1.25

    # MLA (only when attn == MLA)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2) / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0              # hybrid: shared attn block period (layers)

    # enc-dec
    n_enc_layers: int = 0            # 0 = decoder-only
    frontend_stub: bool = False      # audio/vision frontend provides embeddings

    # numerics / runtime
    dtype: str = "bfloat16"
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    remat: str = "none"              # none | full | dots
    # technique applicability note (DESIGN.md §4)
    sub_quadratic: bool = False      # can run long_500k decode

    # ------------------------------------------------------------- derived
    def padded_vocab(self, multiple: int = 256) -> int:
        return _round_up(self.vocab_size, multiple)

    @property
    def qk_head_dim(self) -> int:
        if self.attn == AttnKind.MLA:
            return self.qk_nope_dim + self.qk_rope_dim
        return self.head_dim

    @property
    def v_dim(self) -> int:
        if self.attn == AttnKind.MLA:
            return self.v_head_dim
        return self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Approximate parameter count (for 6ND model-FLOPs accounting)."""
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        v = self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in (Family.DENSE, Family.MOE, Family.ENCDEC):
            if self.attn == AttnKind.MLA:
                qk = self.qk_nope_dim + self.qk_rope_dim
                per_layer += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qk
                per_layer += d * (self.kv_lora_rank + self.qk_rope_dim)
                per_layer += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                per_layer += self.n_heads * self.v_head_dim * d
            else:
                per_layer += d * self.n_heads * self.head_dim * 2  # wq, wo
                per_layer += d * self.n_kv_heads * self.head_dim * 2
        if self.family == Family.MOE:
            per_layer += d * self.n_experts  # router
            per_layer += 3 * d * self.expert_d_ff * self.n_experts
            per_layer += 3 * d * self.shared_d_ff
        elif self.family in (Family.DENSE, Family.ENCDEC):
            per_layer += 3 * d * ff
        if self.family in (Family.SSM, Family.HYBRID):
            di, ns = self.ssm_d_inner, self.ssm_state
            ssm = d * (2 * di + 2 * ns + self.ssm_n_heads) + di * d
            per_layer = ssm
        total = emb + L * per_layer
        if self.family == Family.HYBRID and self.attn_every:
            # one shared attention+FFN block (single copy)
            total += d * self.n_heads * self.head_dim * 2 \
                + d * self.n_kv_heads * self.head_dim * 2 + 3 * d * ff
        if self.family == Family.ENCDEC:
            # decoder mirror of encoder + cross-attention
            total += self.n_enc_layers * (per_layer + d * self.n_heads * self.head_dim * 2
                                          + d * self.n_kv_heads * self.head_dim * 2)
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: shared + top_k experts only)."""
        if self.family != Family.MOE:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * self.n_heads * self.head_dim * 2 \
            + d * self.n_kv_heads * self.head_dim * 2
        ffn = 3 * d * self.expert_d_ff * self.top_k + 3 * d * self.shared_d_ff
        return int(emb + L * (attn + ffn + d * self.n_experts))
