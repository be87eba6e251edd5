"""Hymba-1.5B [arXiv:2411.13676; hf] — hybrid parallel attention+mamba heads.

Every layer runs sliding-window GQA attention and an SSD mixer in parallel on
the same normed input; outputs are mean-fused (the paper's fused parallel
heads, simplified — see DESIGN.md §Arch-applicability).
"""
from repro_torch.models.config import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
    d_ff=5504, vocab_size=32_001,
    sliding_window=1024,
    ssm=SSMCfg(d_state=16, headdim=64, expand=2, d_conv=4, chunk=128),
    tie_embeddings=True,
)


def smoke_config():
    return ModelConfig(
        name="hymba-smoke", family="hybrid",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, sliding_window=8,
        ssm=SSMCfg(d_state=8, headdim=16, expand=2, d_conv=4, chunk=16),
        tie_embeddings=True,
    )
