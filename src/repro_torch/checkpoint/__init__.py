"""Index persistence: sharded checkpoints with an atomic commit (``ckpt``)."""
