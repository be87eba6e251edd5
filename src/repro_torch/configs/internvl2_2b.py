"""InternVL2-2B [arXiv:2404.16821; hf] — InternViT stub + InternLM2 backbone.

The vision tower is a STUB: input_specs() provides precomputed patch
embeddings prepended to the text tokens (B, S_img, d_model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=92_553,
    frontend="vision", tie_embeddings=True,
)


def smoke_config():
    return ModelConfig(
        name="internvl2-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, frontend="vision", tie_embeddings=True,
    )
