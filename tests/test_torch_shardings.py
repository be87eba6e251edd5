"""launch/shardings.py and launch/mesh.py of the port against the reference.

For every LM config of the registry, every applicable shape and both
production meshes (16 x 16, 2 x 16 x 16), the logical-axis rules, the
parameter specs (plain and ``zero2``), the input stand-ins (shapes, dtypes,
specs) and the decode caches' are equal spec for spec.  The reference runs
on a ``jax.sharding.AbstractMesh`` (no devices); the port on a
``DeviceMesh`` over a ``fake`` process group, created and destroyed by a
fixture.  The reference's stacked layer specs carry a leading None the
port's per-layer specs leave out.
"""

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.device_mesh import init_device_mesh

from repro.configs import registry as rreg
from repro.launch import shardings as RS
from repro.models.config import SHAPES as RSHAPES, applicable_shapes
from repro_torch.configs import registry as treg
from repro_torch.launch import dryrun, mesh as tmesh, shardings as TS
from repro_torch.models.config import SHAPES as TSHAPES, InputShape
from repro_torch.models.layers import placements

LM_ARCHS = [a for a in rreg.ARCH_IDS if a != "batann-serve"]
CELLS = [(a, s) for a in LM_ARCHS
         for s in applicable_shapes(rreg.get_config(a))]


@pytest.fixture(params=[False, True], ids=["16x16", "2x16x16"])
def meshes(request):
    """(multi_pod, the reference's abstract mesh, the port's mesh)."""
    multi = request.param
    shape = (2, 16, 16) if multi else (16, 16)
    with dryrun.fake_world(512 if multi else 256):
        yield (multi, AbstractMesh(shape, tmesh.all_axes(multi)),
               tmesh.make_production_mesh(multi_pod=multi))


def _same_tree(port, ref, layer=False, path="params"):
    """Walk the port's spec tree beside the reference's; return the
    mismatching paths."""
    if ref is None or port is None:
        return [] if ref is None and port is None else [path]
    if hasattr(ref, "_fields"):
        assert port._fields == ref._fields, path
        out = []
        for f in ref._fields:
            out += _same_tree(getattr(port, f), getattr(ref, f),
                              layer or f == "layers", f"{path}.{f}")
        return out
    want = tuple(ref)
    got = ((None,) + tuple(port)) if layer else tuple(port)
    return [] if got == want else [f"{path}: {got} != {want}"]


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_rules_and_specs(meshes, arch, shape):
    multi, amesh, tm = meshes
    cfg_r, cfg_t = rreg.get_config(arch), treg.get_config(arch)
    sr, st = RSHAPES[shape], TSHAPES[shape]
    assert TS.make_rules(cfg_t, st, tm, multi).mapping == \
        RS.make_rules(cfg_r, sr, amesh, multi).mapping
    assert _same_tree(TS.make_param_specs(cfg_t, tm, multi),
                      RS.make_param_specs(cfg_r, amesh, multi)) == []
    cell_t = TS.make_cell_sharding(cfg_t, st, tm, multi)
    cell_r = RS.make_cell_sharding(cfg_r, sr, amesh, multi)
    assert (cell_t.batch_axes, cell_t.fsdp) == (cell_r.batch_axes,
                                                 cell_r.fsdp)

    rb, rs = RS.input_specs(cfg_r, sr, amesh, multi)
    tb, ts = TS.input_specs(cfg_t, st, tm, multi)
    assert list(tb) == list(rb) and list(ts) == list(rs)
    for k in rb:
        assert tuple(tb[k].shape) == rb[k].shape, k
        assert tb[k].device.type == "meta"
        assert _dtype_name(tb[k].dtype) == str(rb[k].dtype), k
        assert ts[k] == tuple(rs[k].spec), k

    if sr.kind == "decode":
        rc, rcs = RS.cache_specs(cfg_r, sr, amesh, multi)
        tc, tcs = TS.cache_specs(cfg_t, st, tm, multi)
        for f in rc._fields:
            r, t = getattr(rc, f), getattr(tc, f)
            assert (r is None) == (t is None), f
            if r is None:
                continue
            assert tuple(t.shape) == r.shape and t.device.type == "meta", f
            assert _dtype_name(t.dtype) == str(r.dtype), f
            assert getattr(tcs, f) == tuple(getattr(rcs, f).spec), f


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_zero2_param_specs(meshes, arch):
    multi, amesh, tm = meshes
    got = TS.make_param_specs(treg.get_config(arch), tm, multi, zero2=True)
    want = RS.make_param_specs(rreg.get_config(arch), amesh, multi,
                               zero2=True)
    assert _same_tree(got, want) == []


def test_placements_on_a_fake_mesh(meshes):
    """Specs become one placement per mesh dim; a tuple entry shards its
    tensor dim over each named axis, in mesh order; a DTensor at those
    placements holds this rank's shard."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    multi, _, tm = meshes
    batch = tmesh.batch_axes(multi)
    want = ([Shard(0), Shard(0), Shard(2)] if multi
            else [Shard(0), Shard(2)])
    assert placements(tm, (batch, None, "model")) == want
    assert placements(tm, (None, None)) == [Replicate()] * tm.ndim
    assert placements(tm, (("data", "model"),)) == (
        [Replicate(), Shard(0), Shard(0)] if multi else [Shard(0), Shard(0)])
    with torch._subclasses.fake_tensor.FakeTensorMode():
        x = distribute_tensor(torch.zeros(64, 4, 32), tm,
                              placements(tm, (batch, None, "model")))
        assert tuple(x.to_local().shape) == ((2, 4, 2) if multi
                                             else (4, 4, 2))


@pytest.fixture
def one_device_mesh(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "grok-1-314b", "hymba-1.5b"])
def test_train_step_on_a_one_device_mesh_is_bitwise(one_device_mesh, arch):
    """The hooks live on a real 1 x 1 mesh (DTensor parameters, moments and
    inputs, ``ctx.ax`` from ``make_rules``): one remat train step gives the
    unmeshed step's loss, gradient norm and parameters bit for bit."""
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_loop import TrainConfig, make_train_step

    mesh = one_device_mesh
    cfg = treg.get_smoke_config(arch)
    shape = InputShape("t", 16, 4, "train")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 4, 16)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[0]),
             "labels": torch.from_numpy(toks[1])}
    tcfg = TrainConfig(batch=4, seq_len=16)

    def run(ctx, place):
        params = T.init_params(cfg, seed=1, device="cpu")
        state = O.init(tcfg.opt, params)
        params, state, b = place(params, state, batch)
        with T.mesh_scope(ctx):
            params, state, m = make_train_step(cfg, tcfg, ctx)(params,
                                                              state, b)
        return params, m

    p0, m0 = run(T.RunCtx(remat=True), lambda p, s, b: (p, s, b))

    cell = TS.make_cell_sharding(cfg, shape, mesh, False)
    _, bspecs = TS.input_specs(cfg, shape, mesh, False)

    def place(params, state, b):
        from torch.distributed.tensor import distribute_tensor

        specs = cell.param_specs
        p = TS.place_params(params, mesh, specs).requires_grad_(True)
        s = O.OptState(step=0, m=TS.place_params(state.m, mesh, specs),
                       v=TS.place_params(state.v, mesh, specs))
        s.m.requires_grad_(False)
        s.v.requires_grad_(False)
        b = {k: distribute_tensor(v, mesh, placements(mesh, bspecs[k]))
             for k, v in b.items()}
        return p, s, b

    ctx = T.RunCtx(ax=cell.rules, mesh=mesh, batch_axes=cell.batch_axes,
                   remat=True)
    p1, m1 = run(ctx, place)
    assert torch.equal(m1["loss"].full_tensor(), m0["loss"])
    assert torch.equal(m1["grad_norm"].full_tensor(), m0["grad_norm"])
    for (name, a), b in zip(p0.named_parameters(), p1.parameters()):
        assert torch.equal(b.full_tensor(), a), name
