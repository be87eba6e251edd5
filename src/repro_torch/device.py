"""Device selection, precision pins and the environment record.

Every entry point of the port takes ``device=`` and defaults to ``"cuda"``.
Asking for CUDA where no card is visible raises: nothing silently falls back
to the host.  The CPU runs only when the caller passes ``device="cpu"`` (the
tests do), and then every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import time

import torch

DEFAULT_DEVICE = "cuda"


def pin_precision() -> None:
    """Keep float32 products in float32 (the reference's math): no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: "str | torch.device | None" = DEFAULT_DEVICE
                   ) -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and absent."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but torch sees no CUDA device; "
            "pass device='cpu' to run the plain PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu: {device!r}")
    return dev


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed(timings: "dict | None", name: str, device: torch.device):
    """Record the wall seconds of the block (device work included) under
    ``timings[name]``; a no-op when ``timings`` is None."""
    if timings is None:
        yield
        return
    synchronize(device)
    t0 = time.perf_counter()
    yield
    synchronize(device)
    timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


class SyncMeter:
    """Counts the device->host syncs a host loop makes and the wall time
    the host spends blocked in them (waiting for queued device work)."""

    def __init__(self):
        self.count = 0
        self.seconds = 0.0

    def flag(self, t: torch.Tensor) -> bool:
        """``bool(t)`` for a one-element tensor."""
        t0 = time.perf_counter()
        out = bool(t)
        self.seconds += time.perf_counter() - t0
        self.count += 1
        return out

    def wait(self, device: torch.device) -> None:
        """Block until ``device`` has run its queued work (one sync: it
        ends a batch of non-blocking device->host copies)."""
        t0 = time.perf_counter()
        synchronize(device)
        self.seconds += time.perf_counter() - t0
        self.count += 1

    def nonzero(self, mask: torch.Tensor):
        """``mask.nonzero(as_tuple=True)`` (its size is a host value)."""
        t0 = time.perf_counter()
        out = mask.nonzero(as_tuple=True)
        self.seconds += time.perf_counter() - t0
        self.count += 1
        return out


def nvcc_path() -> "str | None":
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on PATH,
    then the toolkit's default install prefix."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def env_record() -> dict:
    """What this process can run on: torch build, card, compiler."""
    rec = {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_count": torch.cuda.device_count()
        if torch.cuda.is_available() else 0,
        "device_name": None,
        "capability": None,
        "nvcc": nvcc_path(),
    }
    if rec["cuda_available"]:
        rec["device_name"] = torch.cuda.get_device_name(0)
        major, minor = torch.cuda.get_device_capability(0)
        rec["capability"] = f"{major}.{minor}"
    return rec


def gpu_missing(rec: "dict | None" = None) -> "str | None":
    """Why the hand-written kernels cannot run here (``None`` if they can)."""
    rec = env_record() if rec is None else rec
    missing = []
    if not rec["cuda_available"]:
        missing.append("no CUDA device")
    if rec["nvcc"] is None:
        missing.append("no nvcc")
    return ", ".join(missing) or None
