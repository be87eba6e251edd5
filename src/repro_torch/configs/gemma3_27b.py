"""Gemma3-27B [gemma3 family; unverified] — 5:1 local:global attention, 128k.

Every 6th layer is global attention (rope_theta 1M); the rest use a 1024-token
sliding window (rope_theta 10k).  long_500k decode is runnable: local layers
attend within the window; the sparse global layers' KV is sharded over the
mesh (see launch/shardings.py).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_head=128,
    d_ff=21_504, vocab_size=262_144,
    qk_norm=True, rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    sliding_window=1024, global_every=6, tie_embeddings=True,
)


def smoke_config():
    return ModelConfig(
        name="gemma3-smoke", family="dense",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, qk_norm=True,
        sliding_window=8, global_every=3, tie_embeddings=True,
    )
