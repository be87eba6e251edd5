"""Kimi K2 1T-A32B [arXiv kimi2; paper-table] — MoE 384 experts top-8 (+1 shared)."""
from repro_torch.models.config import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=2048, vocab_size=163_840,
    moe=MoECfg(n_experts=384, top_k=8, d_expert=2048, n_shared=1),
    rope_theta=50_000.0, tie_embeddings=False,
)


def smoke_config():
    return ModelConfig(
        name="kimi-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=64, vocab_size=256,
        moe=MoECfg(n_experts=8, top_k=2, d_expert=64, n_shared=1),
        tie_embeddings=False,
    )
