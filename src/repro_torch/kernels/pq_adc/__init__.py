"""PQ ADC: the slot-tiled and dense CUDA kernels, wrappers, plain versions."""
