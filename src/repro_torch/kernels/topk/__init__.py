"""Bitonic top-k: CUDA kernel, wrapper and plain version."""
