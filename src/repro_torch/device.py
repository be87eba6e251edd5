"""Device selection, precision pins and the environment record.

Every entry point of the port takes ``device=`` and defaults to ``"cuda"``.
Asking for CUDA where no card is visible raises: nothing silently falls back
to the host.  The CPU runs only when the caller passes ``device="cpu"`` (the
tests do), and then every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import shutil
import time
from typing import NamedTuple

import numpy as np
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


def clock_ns() -> int:
    """The clock of spans and loop records: Unix-epoch nanoseconds,
    the clock ``torch.profiler`` (Kineto) stamps its events with, so a span
    can be laid over a device trace of the same process."""
    return time.time_ns()


@dataclasses.dataclass
class Span:
    """One timed phase of a call: ``parent`` is the index of the enclosing
    span in ``SyncMeter.spans`` (-1 for a call's root), ``call`` the id the
    call's spans share; ``t1_ns`` is -1 while the span is open."""

    name: str
    t0_ns: int
    t1_ns: int
    parent: int
    call: int


class Step(NamedTuple):
    """One step of an engine's loop, recorded after its closing count
    reached the host: the stamp, what finished in it, its inner iterations
    and a (P,) array a partition.  A super-step of the baton engine:
    queries delivered, the iterations of its ``local_advance`` loop, and
    the occupied slots after ``merge_recv``.  A lock-step hop of
    ``beam_search.search_disk`` (the scatter-gather baseline's loop):
    branch rows that finished in the hop, 1, and the rows the hop
    advanced (its live branches)."""

    t_ns: int
    delivered: int
    local_steps: int
    active: np.ndarray


@dataclasses.dataclass
class Loop:
    """The loop of one call: its start stamp, the rows it serves (the
    baton engine's padded batch; the scatter-gather baseline's P·B branch
    rows) and its ``Step`` records."""

    call: int
    t0_ns: int
    batch: int
    steps: list


class _SpanScope:
    def __init__(self, meter: "SyncMeter", name: str):
        self.meter, self.name = meter, name

    def __enter__(self):
        m = self.meter
        m.spans.append(Span(self.name, clock_ns(), -1,
                            m._open[-1] if m._open else -1, m.call_id))
        m._open.append(len(m.spans) - 1)
        return self

    def __exit__(self, *exc):
        m = self.meter
        m.spans[m._open.pop()].t1_ns = clock_ns()
        return False


_NO_SPAN = contextlib.nullcontext()


class SyncMeter:
    """Counts the device->host syncs a host loop makes and the wall time
    the host spends blocked in them (waiting for queued device work).

    It is also the engines' one in-program recorder: the baton engine's
    super-step loop and ``search_disk``'s lock-step hops (the
    scatter-gather baseline) append a ``Loop`` of ``Step`` records to
    ``loops`` (always; they cost no sync), and with ``spans=True`` every
    phase they enter appends a ``Span`` to ``spans``.  With spans off,
    ``span()`` returns a shared no-op context.  Everything stays in
    memory."""

    def __init__(self, spans: bool = False):
        self.count = 0
        self.seconds = 0.0
        self.spans_on = spans
        self.spans: list = []
        self.loops: list = []
        self.call_id = 0
        self._open: list = []

    def span(self, name: str):
        """A context that records the block as the span ``name`` (a child
        of the innermost open span), or does nothing with spans off."""
        return _SpanScope(self, name) if self.spans_on else _NO_SPAN

    def call(self):
        """Start a new call: its id tags the spans and the loop that
        follow; returns the call's root span ``call``."""
        self.call_id += 1
        return self.span("call")

    def loop(self, batch: int) -> None:
        """Stamp the start of the current call's loop."""
        self.loops.append(Loop(self.call_id, clock_ns(), batch, []))

    def step(self, delivered: int, local_steps: int, active) -> None:
        """Record a step of the current loop (stamped now)."""
        self.loops[-1].steps.append(
            Step(clock_ns(), delivered, local_steps, active))

    def host(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` copied to the host: one sync."""
        t0 = time.perf_counter()
        out = t.cpu()
        self.seconds += time.perf_counter() - t0
        self.count += 1
        return out

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
