"""Import discipline and no-fallback rules of the port.

* ``src/repro_torch``, ``chip_smoke.py`` and the port's examples
  (``examples/torch_*.py``) import neither JAX nor the reference package
  (AST scan);
* asking for CUDA without a card raises — nothing falls back to the CPU;
* the modes carried since slice 1 (the lazy queue LUT, the sector layout)
  refuse only what the reference refuses (a lazy refill without the
  codebook, a sector shard of an index built without sector codes).
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import device as tdev
from repro_torch.api.engine import BatonEngine
from repro_torch.core import baton, ref
from repro_torch.data import synth
from repro_torch.serve_async import AsyncServingTier, runtime

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return (files + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("torch_*.py")))


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
    for mod in ("launch/spmd.py", "models/transformer.py", "models/ssm.py",
                "models/moe.py", "serving/rag.py", "serving/decode.py",
                "configs/registry.py", "configs/qwen2_0_5b.py",
                "training/optimizer.py", "training/train_loop.py",
                "launch/train.py"):
        assert ROOT / "src" / "repro_torch" / mod in files, mod
    for name in ("quickstart", "distributed_search", "rag_serve", "train_lm"):
        assert ROOT / "examples" / f"torch_{name}.py" in files, name
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


def test_every_engine_and_the_deployment_default_to_cuda(no_cuda):
    from repro_torch.api import deployment, engine
    from repro_torch.configs.batann_serve import SERVE_CONFIGS

    for cls in engine.ENGINES.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deployment.Deployment.from_config(SERVE_CONFIGS["batann-serve-sg"])


def test_lm_entry_points_default_to_cuda(no_cuda):
    """The LM tenant's constructors run on the card unless the caller asks
    for the CPU: without one they raise."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import transformer
    from repro_torch.serving import rag

    cfg = get_smoke_config("qwen2-0.5b")
    for call in (lambda: transformer.init_params(cfg),
                 lambda: transformer.params_from_tree(cfg, None),
                 lambda: transformer.init_caches(cfg, 1, 4,
                                                 transformer.RunCtx()),
                 lambda: rag.build_demo(n_docs=50, d=8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_training_entry_points_default_to_cuda(no_cuda):
    """The trainer, the opt-state carrier and the launcher run on the card
    unless asked for the CPU: without one they raise."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import train as launch_train
    from repro_torch.training import optimizer, train_loop

    cfg = get_smoke_config("qwen2-0.5b")
    for call in (lambda: train_loop.train(cfg, train_loop.TrainConfig(
                     steps=1), verbose=False),
                 lambda: optimizer.opt_state_from_tree(cfg, optimizer.OptState(
                     step=0, m=None, v=None)),
                 lambda: launch_train.main(["--arch", "qwen2-0.5b",
                                            "--smoke", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_env_record_names_what_is_missing(no_cuda, monkeypatch):
    monkeypatch.setattr(tdev, "nvcc_path", lambda: None)
    rec = tdev.env_record()
    for key in ("torch", "torch_cuda", "cuda_available", "device_name",
                "capability", "nvcc"):
        assert key in rec
    assert tdev.gpu_missing(rec) == "no CUDA device, no nvcc"
    assert tdev.gpu_missing({"cuda_available": True, "nvcc": "/x"}) is None


@pytest.mark.parametrize("kw", [dict(lazy_queue_lut=True),
                                dict(lazy_queue_lut=True, fused=False)])
def test_modes_not_carried_raise(kw):
    """The lazy queue LUT is carried on the fused and the per-slot path
    alike: the queue keeps a (P, 1, M, K) placeholder, and a refill without
    the codebook to build the LUTs from raises."""
    cfg = baton.BatonParams(**kw)
    assert cfg.lazy_queue_lut and cfg.fused == kw.get("fused", True)
    P, Q, d, m, k = 2, 3, 8, 2, 4
    cb = torch.zeros((m, k, d // m))
    dev = baton.init_device_state(
        torch.zeros((P, Q, d)), torch.arange(P * Q).reshape(P, Q),
        torch.zeros((P, Q, 4), dtype=torch.int32), torch.zeros((P, Q, 4)),
        cfg, cb)
    assert tuple(dev.queue_lut.shape) == (P, 1, m, k)
    parts = torch.arange(P, dtype=torch.int32)
    with pytest.raises(ValueError, match="codebook"):
        baton.refill(dev, cfg, parts)
    seeded = baton.refill(dev, cfg, parts, codebook=cb)
    assert tuple(seeded.states.lut.shape) == (P, cfg.slots, m, k)


def test_dense_adc_route_is_carried():
    assert baton.BatonParams(adc_impl="mxu").adc_impl == "mxu"


def _tiny(codes_mode="replicated", partitioner="ldg"):
    v = np.random.default_rng(0).normal(size=(80, 8)).astype(np.float32)
    return v, baton.build_index(
        v, p=2, partitioner=partitioner, pq_m=4, pq_k=8, device="cpu",
        codes_mode=codes_mode,
        graph=baton.vamana.build(v, r=4, l_build=8, device="cpu"))


def test_partition_shard_sector_codes_raise():
    """A sector shard of a replicated index raises; of a sector index it is
    row ``part`` of the sector codes beside a (1, M) placeholder."""
    _, rep = _tiny()
    with pytest.raises(ValueError, match="codes_mode='sector'"):
        runtime.partition_shard(rep, 0, sector_codes=True)
    _, sec = _tiny("sector")
    shard = runtime.partition_shard(sec, 1, sector_codes=True)
    assert torch.equal(shard.nbr_codes[0], sec.part_nbr_codes[1])
    assert tuple(shard.codes.shape) == (1, 4)
    assert runtime.partition_shard(sec, 1).nbr_codes is None


def test_sector_codes_and_kmeans_raise():
    """Sector codes build and load (an unknown ``codes_mode`` raises);
    ``partitioner="kmeans"`` builds with the balanced k-means assignment."""
    v, sec = _tiny("sector")
    with pytest.raises(ValueError, match="codes_mode"):
        baton.build_index(v, p=2, codes_mode="aisaq", device="cpu")
    tree, meta = BatonEngine(device="cpu").attach(sec).index_state()
    back = BatonEngine(device="cpu").load_index(tree, meta)
    assert torch.equal(back.part_nbr_codes, sec.part_nbr_codes)
    _, idx = _tiny(partitioner="kmeans")
    np.testing.assert_array_equal(
        idx.assign, baton.part_mod.balanced_kmeans(v, 2, seed=0))
