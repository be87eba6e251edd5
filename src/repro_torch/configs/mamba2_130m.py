"""Mamba2-130M [arXiv:2405.21060] — attention-free SSD (state-space duality)."""
from repro_torch.models.config import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab_size=50_280,
    ssm=SSMCfg(d_state=128, headdim=64, expand=2, d_conv=4, chunk=128),
    tie_embeddings=True,
)


def smoke_config():
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_head=0,
        d_ff=0, vocab_size=256,
        ssm=SSMCfg(d_state=16, headdim=16, expand=2, d_conv=4, chunk=16),
        tie_embeddings=True,
    )
