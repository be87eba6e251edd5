"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``.cu`` file exports plain ``extern "C"`` launchers, so a build needs
only ``nvcc`` (no PyTorch headers, no ninja) and takes seconds.  Libraries go
to ``build/torch_kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the source and the flags, and are built
at first use; ``build()`` starts one ``nvcc`` per source, all at once.  A
failed build or launch raises: nothing falls back to the plain version.
Loading is serialised by a lock (worker threads may ask for a library at
once), and so is every wrapper's launch count (``count_launch``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.device import nvcc_path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel library -> (source, {exported function: ctypes argtypes})
_VP, _I = ctypes.c_void_p, ctypes.c_int
SOURCES = {
    "topk": ("topk/topk.cu", {
        "bitonic_topk_launch": [_VP, _VP, _I, _VP, _VP, _I, _I, _I, _I,
                                _I, _I, _VP, _VP, _VP, _VP],
    }),
    "pq_adc_slots": ("pq_adc/adc_slots.cu", {
        "adc_slots_launch": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
    }),
    "pq_adc": ("pq_adc/adc.cu", {
        "adc_dense_launch": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
    }),
    "pq_lut": ("pq_lut/lut.cu", {
        "pq_lut_launch": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
    }),
    "cand_filter": ("cand_filter/filter.cu", {
        "cand_filter_launch": [_VP, _I, _VP, _I, _VP, _I, _I, _I, _VP, _VP],
    }),
}
_ERROR_STRING = {"topk": "topk_error_string",
                 "pq_adc_slots": "adc_error_string",
                 "pq_adc": "adc_dense_error_string",
                 "pq_lut": "pq_lut_error_string",
                 "cand_filter": "cand_filter_error_string"}

_loaded: dict = {}   # name -> ctypes.CDLL (one load per process)
_load_lock = threading.Lock()
_count_lock = threading.Lock()


def source_path(name: str) -> Path:
    return _PKG / SOURCES[name][0]


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the headers
    beside it (``*.cuh``) and the flags."""
    path = source_path(name)
    src = b"".join(p.read_bytes() for p in
                   [path, *sorted(path.parent.glob("*.cuh"))])
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build(names=None) -> dict:
    """Compile every named kernel library that is not built yet, one
    ``nvcc`` per source, all started together.  Returns {name: compiler
    log} for the libraries compiled by this call (``-Xptxas -v`` reports
    registers and shared memory per kernel)."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels "
                           f"{todo} (set CUDA_HOME or put nvcc on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(n))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{logs[n]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``name``, built first if needed."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SOURCES[name][1].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            err_fn = getattr(lib, _ERROR_STRING[name])
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
            _loaded[name] = lib
    return lib


def count_launch(fn, attr: str = "launches") -> None:
    """Add one to ``fn.launches`` (a wrapper's launch count), or to
    another of its counts."""
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + 1)


def check_launch(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = getattr(load(name), _ERROR_STRING[name])(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{err} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
