"""MusicGen-large [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.

The EnCodec frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, S, d_model); the backbone is the standard decoder stack.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab_size=2048,
    frontend="audio", tie_embeddings=False,
)


def smoke_config():
    return ModelConfig(
        name="musicgen-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=64, frontend="audio", tie_embeddings=False,
    )
