"""The port's mesh dry run (launch/dryrun.py, hlo_stats.py, roofline.py)
and ``transformer.abstract_params`` against the reference.

* ``abstract_params`` of all ten LM configs: the reference's leaves' shapes
  and dtypes (its stacked (n_layers, ...) layout through
  ``transformer.stacked_tree``), every tensor on the meta device.
* One dense and one MoE smoke config dry-run as train, prefill and decode
  cells on a 2 x 2 mesh over a ``fake`` process group: each completes with
  the reference's record keys and counts per device.
* FLOPs per rank: one sharded product counts its shard's FLOPs.
* The collective tally on redistributions worked out by hand.
* ``model_flops``, ``analyze``, ``suggest`` and ``pick_hillclimb_cells``
  equal the reference's on the same records under the reference's TPU
  constants (declared here only: the port's default is the H100).
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh

from repro.configs import registry as rreg
from repro.launch import roofline as RR
from repro.models import transformer as RT
from repro_torch.configs import registry as treg
from repro_torch.launch import dryrun, hlo_stats, roofline as TR
from repro_torch.models import transformer as TT
from repro_torch.models.config import InputShape

LM_ARCHS = [a for a in rreg.ARCH_IDS if a != "batann-serve"]
# the keys of a record of the reference's run_cell (memory keys included)
REF_KEYS = {"arch", "shape", "mesh", "n_devices", "lower_s", "compile_s",
            "flops", "bytes_accessed", "collectives", "hlo_instructions",
            "microbatches", "flops_from_unrolled", "argument_size_in_bytes",
            "output_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes", "params", "active_params",
            "variant"}
# the reference's hardware (roofline.py:27-29), for the comparison only
TPU = TR.Hardware(name="TPU v5e (the reference's constants)",
                  peak_flops=RR.PEAK_FLOPS, hbm_bw=RR.HBM_BW,
                  link_bw=RR.ICI_BW, hbm_bytes=16e9)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_abstract_params(arch):
    want = RT.abstract_params(rreg.get_config(arch), jnp.bfloat16)
    got = TT.abstract_params(treg.get_config(arch), torch.bfloat16)
    assert all(w.device.type == "meta" for w in got.parameters())
    leaf = lambda w: (tuple(w.shape), str(w.dtype).split(".")[-1])  # noqa
    tree = TT.stacked_tree(
        got, leaf, lambda ws: ((len(ws),) + tuple(ws[0].shape),
                               str(ws[0].dtype).split(".")[-1]))
    flat_got = jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple)
                               and not hasattr(x, "_fields"))
    flat_want = [(w.shape, str(w.dtype)) for w in jax.tree.leaves(want)]
    assert jax.tree.structure(want).num_leaves == len(flat_got)
    assert flat_got == flat_want


@pytest.fixture(scope="module")
def mesh2x2():
    with dryrun.fake_world(4):
        yield init_device_mesh("cpu", (2, 2),
                               mesh_dim_names=("data", "model"))


SMOKE_SHAPES = [InputShape("train_4k", 64, 8, "train"),
                InputShape("prefill_32k", 64, 4, "prefill"),
                InputShape("decode_32k", 64, 4, "decode")]


@pytest.fixture(scope="module")
def smoke_records(mesh2x2):
    """Dry-run records of qwen2-smoke and grok-smoke, one per kind."""
    out = {}
    for arch in ("qwen2-0.5b", "grok-1-314b"):
        cfg = treg.get_smoke_config(arch)
        for shape in SMOKE_SHAPES:
            out[arch, shape.kind] = dryrun.cell_record(arch, cfg, shape,
                                                       mesh2x2, False)
    return out


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "grok-1-314b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_smoke_dry_run(smoke_records, arch, kind):
    rec = smoke_records[arch, kind]
    assert REF_KEYS <= set(rec)
    assert rec["torch_version"] == torch.__version__
    assert rec["mesh"] == "2x2" and rec["n_devices"] == 4
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["argument_size_in_bytes"] > 0
    assert rec["temp_size_in_bytes"] > 0
    coll = rec["collectives"]
    assert coll["total"]["count"] == sum(
        v["count"] for k, v in coll.items() if k != "total") > 0
    # experts live on their owners: the MoE cells exchange tokens
    assert ("all-to-all" in coll) == (arch == "grok-1-314b")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "grok-1-314b"])
def test_train_cell_argument_bytes(smoke_records, mesh2x2, arch):
    """A train cell's arguments on rank 0: its shards of the float32
    params, of both float32 moments and of the (8, 64) int32 tokens and
    labels (batch over the 2 data ranks); its outputs the state alone."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import shardings as TS

    cfg = treg.get_smoke_config(arch)
    with FakeTensorMode():
        params = dryrun._place(TT.abstract_params(cfg), mesh2x2,
                               TS.make_param_specs(cfg, mesh2x2, False))
        p_bytes = dryrun._local_bytes(params)
    rec = smoke_records[arch, "train"]
    assert rec["output_size_in_bytes"] == 3 * p_bytes
    assert rec["argument_size_in_bytes"] == 3 * p_bytes + 2 * (8 // 2) * 64 * 4


def test_flops_per_rank(mesh2x2):
    """x (256, 4096) batch-sharded over data, w (4096, 8192) column-sharded
    over model: each rank multiplies (128, 4096) by (4096, 4096)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with FakeTensorMode():
        x = distribute_tensor(torch.zeros(256, 4096), mesh2x2,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.zeros(4096, 8192), mesh2x2,
                              [Replicate(), Shard(1)])
        counter = dryrun.LocalCounter()
        with dryrun.outside_propagation(counter), counter:
            x @ w
    assert counter.flops == 2 * 128 * 4096 * 4096


def test_collective_tally(mesh2x2):
    """Per-device output bytes of three redistributions of a float32 (8,
    16) tensor on the data axis: an all-gather (the whole tensor, 512 B), an
    all-reduce of partial sums (512 B) and a reduce-scatter (half, 256 B)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    with FakeTensorMode():
        t = torch.zeros(4, 16)
        full = torch.zeros(8, 16)
        rep = [Replicate(), Replicate()]
        tally = hlo_stats.CollectiveTally()
        with tally:
            DTensor.from_local(t, mesh2x2, [Shard(0), Replicate()],
                               run_check=False).redistribute(mesh2x2, rep)
            DTensor.from_local(full, mesh2x2, [Partial(), Replicate()],
                               run_check=False).redistribute(mesh2x2, rep)
            DTensor.from_local(full, mesh2x2, [Partial(), Replicate()],
                               run_check=False).redistribute(
                mesh2x2, [Shard(0), Replicate()])
    assert hlo_stats.collective_stats(tally.seen) == {
        "all-gather": {"count": 1, "bytes": 512},
        "all-reduce": {"count": 1, "bytes": 512},
        "reduce-scatter": {"count": 1, "bytes": 256},
        "total": {"count": 3, "bytes": 1280},
    }


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def _records(smoke_records):
    """The smoke cells' counts under production cell names (model_flops
    reads the registry), plus a layer-scan record and a batann-serve one,
    so every branch of ``analyze`` runs."""
    names = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}
    recs = []
    for (arch, kind), rec in sorted(smoke_records.items()):
        rec = dict(rec, arch=arch, shape=names[kind],
                   microbatches=8 if kind == "train" else 1)
        del rec["input_shape"]           # the production cell's shape
        recs.append(rec)
    recs.append(dict(recs[0], arch="gemma3-27b", flops_from_unrolled=False))
    recs.append(dict(recs[1], arch="batann-serve", shape="serve",
                     flops=float("nan"), flops_from_unrolled=False))
    return recs


def test_roofline_equals_reference(smoke_records):
    recs = _records(smoke_records)
    for rec in recs:
        assert _same(TR.model_flops(rec), RR.model_flops(rec))
        got, want = TR.analyze(rec, TPU), RR.analyze(rec)
        assert got.pop("fits_hbm") == want.pop("fits_16g")
        assert got.keys() == want.keys()
        for k in want:
            assert _same(got[k], want[k]), (rec["arch"], k)
        assert TR.suggest(rec, got) == RR.suggest(rec, want)
    lm = [r for r in recs if r["arch"] != "batann-serve"]
    assert TR.pick_hillclimb_cells(recs, TPU) == RR.pick_hillclimb_cells(
        recs)
    # the H100 default: the same terms over its own rates
    a = TR.analyze(lm[0])
    assert np.isclose(a["t_compute"] * TR.H100.peak_flops,
                      TR.analyze(lm[0], TPU)["t_compute"] * TPU.peak_flops)


def test_roofline_load_refuses_two_torch_versions(tmp_path):
    """Counts of two torch versions do not mix in one table."""
    rec = {"arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "16x16"}
    for i, v in enumerate(("2.11.0", "2.13.0")):
        with open(tmp_path / f"r{i}.json", "w") as f:
            json.dump(dict(rec, torch_version=v), f)
    assert len(TR.load(str(tmp_path / "none"), None)) == 0
    with pytest.raises(ValueError, match="2.11.0, 2.13.0"):
        TR.load(str(tmp_path), None)
    os.remove(tmp_path / "r0.json")
    assert len(TR.load(str(tmp_path), "16-16")) == 1
