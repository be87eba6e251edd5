"""Slot-tiled PQ ADC: CUDA kernel, wrapper and plain version."""
