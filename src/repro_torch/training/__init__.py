"""Training: AdamW with a warmup-cosine schedule and global clipping, the
microbatched train step and the resumable train loop."""
