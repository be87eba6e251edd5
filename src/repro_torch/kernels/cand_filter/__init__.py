"""Candidate filter: CUDA kernel, wrapper and plain version."""
