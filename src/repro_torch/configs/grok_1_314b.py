"""Grok-1 314B [hf:xai-org/grok-1] — MoE 8 experts top-2."""
from repro_torch.models.config import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=32_768, vocab_size=131_072,
    moe=MoECfg(n_experts=8, top_k=2, d_expert=32_768, pad_to=16),
    tie_embeddings=True,
)


def smoke_config():
    return ModelConfig(
        name="grok-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256,
        moe=MoECfg(n_experts=4, top_k=2, d_expert=128),
        tie_embeddings=True,
    )
