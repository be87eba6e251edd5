"""Import discipline and no-fallback rules of the port.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither JAX nor the
  reference package (AST scan);
* asking for CUDA without a card raises — nothing falls back to the CPU;
* modes the port does not carry yet raise ``NotImplementedError`` naming
  their ROADMAP item.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import device as tdev
from repro_torch.api.engine import BatonEngine
from repro_torch.configs.batann_serve import ExecSpec
from repro_torch.core import baton, ref
from repro_torch.data import synth
from repro_torch.serve_async import AsyncServingTier, runtime
from repro_torch.serve_async.queues import ProcessInbox

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = _port_files()
    assert len(files) > 15
    bad = [f"{p.relative_to(ROOT)}:{line}: {mod}"
           for p in files for line, mod in _imported_modules(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_scan_catches_a_reference_import(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import os\nfrom repro.core import pq\nimport jax.numpy\n")
    mods = [m for _, m in _imported_modules(p)]
    assert [m for m in mods if m.split(".")[0] in FORBIDDEN] == [
        "repro.core", "jax.numpy"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_without_a_card_raises(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.resolve_device(None)
    with pytest.raises(RuntimeError):
        BatonEngine()
    with pytest.raises(RuntimeError):
        ref.brute_force_knn(np.zeros((4, 2), np.float32),
                            np.zeros((1, 2), np.float32), 1)
    with pytest.raises(RuntimeError):
        synth.make_dataset("deep", n=50, n_queries=2)
    assert tdev.resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        tdev.resolve_device("meta")


def test_env_record_names_what_is_missing(no_cuda, monkeypatch):
    monkeypatch.setattr(tdev, "nvcc_path", lambda: None)
    rec = tdev.env_record()
    for key in ("torch", "torch_cuda", "cuda_available", "device_name",
                "capability", "nvcc"):
        assert key in rec
    assert tdev.gpu_missing(rec) == "no CUDA device, no nvcc"
    assert tdev.gpu_missing({"cuda_available": True, "nvcc": "/x"}) is None


@pytest.mark.parametrize("kw", [dict(fused=False), dict(lazy_queue_lut=True)])
def test_modes_not_carried_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        baton.BatonParams(**kw)


def test_dense_adc_route_is_carried():
    assert baton.BatonParams(adc_impl="mxu").adc_impl == "mxu"


def test_exec_process_mode_raises():
    """ExecSpec(mode="process") is a valid config; the tier refuses it."""
    spec = ExecSpec(workers=1, mode="process")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        AsyncServingTier(None, baton.BatonParams(), n_workers=1,
                         mode=spec.mode)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ProcessInbox()


def test_partition_shard_sector_codes_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        runtime.partition_shard(None, 0, sector_codes=True)


def test_sector_codes_and_kmeans_raise():
    v = np.random.default_rng(0).normal(size=(80, 8)).astype(np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        baton.build_index(v, p=2, codes_mode="sector", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BatonEngine(device="cpu").load_index(
            {"part_nbr_codes": np.zeros((1, 1, 1, 1), np.uint8)}, {})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        baton.build_index(v, p=2, partitioner="kmeans", pq_m=4, pq_k=8,
                          device="cpu",
                          graph=baton.vamana.build(v, r=4, l_build=8,
                                                   device="cpu"))
