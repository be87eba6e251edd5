"""PQ lookup-table build: CUDA kernel ``lut.cu``, wrapper, plain version."""
