"""Model configuration schema for the LM tenant's architecture zoo.

Counterpart of ``repro/models/config.py``: the same dataclasses, shapes and
parameter arithmetic, kept as the port's own copy (the port imports nothing
of the reference).  One unified decoder-LM description covers dense GQA
transformers, MoE, Mamba2 (SSD), hybrid attn+SSM, and stub-fronted
audio/vision backbones.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int            # per-expert FFN hidden dim
    n_shared: int = 0        # shared (always-on) experts
    capacity_factor: float = 1.25
    pad_to: int = 0          # pad expert SLOTS for EP divisibility (grok:
    #                          8 experts -> 16 slots on the 16-wide data
    #                          axis; dummies get no routed tokens)

    @property
    def n_slots(self) -> int:
        return max(self.n_experts, self.pad_to)


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int             # N
    headdim: int = 64        # P
    expand: int = 2          # d_inner = expand * d_model
    d_conv: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_global: float = 1_000_000.0   # gemma3 global layers
    sliding_window: Optional[int] = None     # local-attention window
    global_every: int = 0    # gemma3: every Nth layer is global (0 = all global)
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    tie_embeddings: bool = True
    frontend: Optional[str] = None           # 'audio' | 'vision' stub
    norm_eps: float = 1e-6

    # ---- derived ----------------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def pure_full_attention(self) -> bool:
        """True when every layer is unwindowed attention (long_500k skip)."""
        return (
            self.family not in ("ssm", "hybrid")
            and self.sliding_window is None
        )

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm.headdim if self.ssm else 0

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs in §Roofline)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += V * D
        per_layer = 0
        if self.family != "ssm":
            qkv = D * self.n_heads * self.d_head + 2 * D * self.n_kv_heads * self.d_head
            per_layer += qkv + self.n_heads * self.d_head * D
        if self.ssm is not None:
            di, ns = self.d_inner_ssm, self.ssm.d_state
            h = self.n_ssm_heads
            per_layer += D * (2 * di + 2 * ns + h) + di * D + 3 * h
        if self.moe is not None:
            e = self.moe
            per_layer += D * e.n_experts  # router
            per_layer += (e.n_experts + e.n_shared) * 3 * D * e.d_expert
        elif self.family != "ssm" and F > 0:
            per_layer += 3 * D * F
        per_layer += 2 * D  # norms
        return n + L * per_layer + D

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: top-k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        total = self.param_count()
        all_experts = self.n_layers * e.n_experts * 3 * self.d_model * e.d_expert
        active = self.n_layers * (e.top_k + e.n_shared) * 3 * self.d_model * e.d_expert
        shared = self.n_layers * e.n_shared * 3 * self.d_model * e.d_expert
        return total - all_experts - shared + active


# ---------------------------------------------------------------------------
# input shapes (assigned): every (arch x shape) pair is a dry-run cell
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """long_500k needs sub-quadratic attention (skip pure full-attention)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if not cfg.pure_full_attention:
        out.append("long_500k")
    return out
