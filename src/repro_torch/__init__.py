"""BatANN's baton search ported to PyTorch and CUDA (NVIDIA Hopper).

The JAX package ``repro`` is the reference; this package imports neither it
nor JAX.  Module names mirror ``repro`` so each counterpart is easy to find.
Importing the package pins float32 products to full float32 (no TF32).
"""

from repro_torch.device import (
    env_record, gpu_missing, pin_precision, resolve_device,
)

pin_precision()

__all__ = ["env_record", "gpu_missing", "pin_precision", "resolve_device"]
