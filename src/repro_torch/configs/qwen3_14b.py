"""Qwen3-14B [hf:Qwen/Qwen3-14B family] — dense GQA (kv=8), qk_norm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=17_408, vocab_size=151_936,
    qk_norm=True, rope_theta=1_000_000.0, tie_embeddings=False,
)


def smoke_config():
    return ModelConfig(
        name="qwen3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=160, vocab_size=256, qk_norm=True, tie_embeddings=False,
    )
