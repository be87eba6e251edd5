"""Qwen2-0.5B [arXiv:2407.10671; hf] — dense GQA (kv=2), QKV bias."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64,
    d_ff=4864, vocab_size=151_936,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=True,
)


def smoke_config():
    return ModelConfig(
        name="qwen2-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, qkv_bias=True, tie_embeddings=True,
    )
