"""models/moe.py::moe_ep of the port against the reference's moe_ep.

kimi-smoke (with its shared expert, through ``moe_forward``) and grok-smoke,
at capacity factors that drop (token, expert) pairs and factors that drop
none:

* on a 1 x 1 mesh in the pytest process (a one-rank gloo group, created and
  destroyed by a fixture) against the reference on a one-device mesh;
* at 4 gloo ranks as (data, model) = (4, 1) and (2, 2), spawned from a
  subprocess, against the reference on 4 forced host devices in another
  subprocess (as ``tests/test_spmd.py`` runs it).

Outputs within rtol 1e-4 / atol 1e-5.  The keep masks (which pairs reach
their expert) are equal exactly: the port's ``_dispatch`` on each data
shard's tokens against the reference's formulas on the same routing.
Run as a script, it prints the largest output difference of each case.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.models import moe as RM
from repro_torch.configs import registry as treg
from repro_torch.models import moe as TM
from repro_torch.models.config import MoECfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["kimi-k2-1t-a32b", "grok-1-314b"]
B, S = 8, 16


def _cfgs(arch, cf):
    cfg_r = rreg.get_smoke_config(arch)
    cfg_r = dataclasses.replace(
        cfg_r, moe=dataclasses.replace(cfg_r.moe, capacity_factor=cf))
    cfg_t = dataclasses.replace(treg.get_smoke_config(arch), moe=MoECfg(
        **dataclasses.asdict(cfg_r.moe)))
    return cfg_r, cfg_t


def _arrays(cfg, seed):
    """Seeded MoE weights, the shared expert's and the input (B, S, D)."""
    rng = np.random.default_rng(seed)
    d, e, fe, slots = (cfg.d_model, cfg.moe.n_experts, cfg.moe.d_expert,
                       cfg.moe.n_slots)
    out = dict(w_router=rng.normal(size=(d, e)) / np.sqrt(d),
               wg=rng.normal(size=(slots, d, fe)) / np.sqrt(d),
               wu=rng.normal(size=(slots, d, fe)) / np.sqrt(d),
               wd=rng.normal(size=(slots, fe, d)) / np.sqrt(fe),
               x=rng.normal(size=(B, S, d)))
    if cfg.moe.n_shared:
        f = cfg.moe.d_expert * cfg.moe.n_shared
        out.update(w_gate=rng.normal(size=(d, f)) / np.sqrt(d),
                   w_up=rng.normal(size=(d, f)) / np.sqrt(d),
                   w_down=rng.normal(size=(f, d)) / np.sqrt(f))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _ref_keep(cfg, a, ed):
    """The reference's keep mask per data shard: its routing and the lines
    of its ``moe_ep`` that rank each pair within its destination."""
    e_loc = cfg.moe.n_slots // ed
    k = cfg.moe.top_k
    out = []
    for x_loc in np.split(a["x"], ed):
        t_loc = x_loc.shape[0] * x_loc.shape[1]
        _, ids = RM._route(cfg, jnp.asarray(a["w_router"]),
                           jnp.asarray(x_loc.reshape(t_loc, -1)))
        owner = ids.reshape(-1) // e_loc
        cap = max(1, int(round(t_loc * k / ed * cfg.moe.capacity_factor)))
        onehot = jax.nn.one_hot(owner, ed, dtype=jnp.int32)
        rank = jnp.cumsum(onehot, axis=0) - onehot
        out.append(np.asarray(jnp.sum(rank * onehot, axis=1) < cap))
    return out


def _port_keep(cfg, a, ed):
    e_loc = cfg.moe.n_slots // ed
    k = cfg.moe.top_k
    out = []
    for x_loc in np.split(a["x"], ed):
        t_loc = x_loc.shape[0] * x_loc.shape[1]
        _, ids = TM._route(cfg, torch.from_numpy(a["w_router"]),
                           torch.from_numpy(x_loc.reshape(t_loc, -1)))
        cap = max(1, int(round(t_loc * k / ed * cfg.moe.capacity_factor)))
        keep, _ = TM._dispatch(torch.div(ids.reshape(-1), e_loc,
                                         rounding_mode="floor"), ed, cap)
        out.append(keep.numpy())
    return out


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


# (arch, capacity factor, drops at (4, 1)?) -- the factors are chosen per
# mesh in the cases below; 1 x 1 drops only below 1.0
CASES_1x1 = [(a, cf) for a in ARCHS for cf in (0.5, 1.25)]
CASES_4 = [(shape, a, cf) for shape in ((4, 1), (2, 2)) for a in ARCHS
           for cf in (1.0, 4.0)]


@pytest.fixture
def one_rank_mesh(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,cf", CASES_1x1)
def test_moe_ep_one_device(one_rank_mesh, arch, cf):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.layers import placements

    cfg_r, cfg_t = _cfgs(arch, cf)
    a = _arrays(cfg_r, seed=11)
    names = ("w_router", "wg", "wu", "wd")
    ref_mesh = jax.make_mesh((1, 1), ("data", "model"))
    want = jax.jit(lambda p, x: RM.moe_ep(cfg_r, p, x, ref_mesh, ("data",)))(
        RM.MoEParams(*(jnp.asarray(a[n]) for n in names)),
        jnp.asarray(a["x"]))
    mesh = one_rank_mesh
    specs = {"w_router": (None, None), "wg": ("data", None, "model"),
             "wu": ("data", None, "model"), "wd": ("data", "model", None)}
    p = TM.MoEParams(**{n: distribute_tensor(
        torch.from_numpy(a[n]), mesh, placements(mesh, specs[n]))
        for n in names})
    x = distribute_tensor(torch.from_numpy(a["x"]), mesh,
                          placements(mesh, ("data", None, None)))
    with torch.no_grad():
        got = TM.moe_ep(cfg_t, p, x, mesh, ("data",)).full_tensor()
    print(f"moe_ep 1x1 {arch} cf={cf}: max |diff| {_close(got, want):.3g}")
    keep_r, keep_t = _ref_keep(cfg_r, a, 1), _port_keep(cfg_t, a, 1)
    np.testing.assert_array_equal(keep_t[0], keep_r[0])
    assert keep_r[0].all() == (cf >= 1.0)


_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    sys.path.insert(0, {tests!r})
    import test_torch_moe_ep as t
    from repro.models import layers as RL, moe as RM
    out = {{}}
    for shape, arch, cf in t.CASES_4:
        cfg, _ = t._cfgs(arch, cf)
        a = t._arrays(cfg, seed=12)
        mesh = jax.make_mesh(shape, ("data", "model"))
        p = RM.MoEParams(*(jnp.asarray(a[n]) for n in
                           ("w_router", "wg", "wu", "wd")))
        sh = RL.MLPParams(*(jnp.asarray(a[n]) for n in
                            ("w_gate", "w_up", "w_down"))) \\
            if cfg.moe.n_shared else None
        f = jax.jit(lambda p, x, sh: RM.moe_forward(
            cfg, p, x, shared_mlp=sh, mesh=mesh, batch_axes=("data",)))
        out[f"{{shape}}-{{arch}}-{{cf}}"] = np.asarray(
            f(p, jnp.asarray(a["x"]), sh))
    np.savez({path!r}, **out)
""")

_PORT = textwrap.dedent("""
    import dataclasses, json
    import numpy as np, torch, torch.distributed as dist
    import torch.multiprocessing as mp

    def rank_main(rank, init):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.configs.registry import get_smoke_config
        from repro_torch.models import layers as L, moe as TM
        from repro_torch.models.layers import placements
        torch.set_num_threads(1)       # four ranks share the host's cores
        dist.init_process_group("gloo", init_method="file://" + init,
                                rank=rank, world_size=4)
        specs = {{"w_router": (None, None), "wg": ("data", None, "model"),
                  "wu": ("data", None, "model"),
                  "wd": ("data", "model", None),
                  "w_gate": (None, "model"), "w_up": (None, "model"),
                  "w_down": ("model", None), "x": ("data", None, None)}}
        arrays = np.load({inputs!r})
        out = {{}}
        for shape, arch, cf in json.load(open({cases!r})):
            key = f"{{tuple(shape)}}-{{arch}}-{{cf}}"
            cfg = get_smoke_config(arch)
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf))
            mesh = init_device_mesh("cpu", tuple(shape),
                                    mesh_dim_names=("data", "model"))
            d = {{n.split("/")[1]: distribute_tensor(
                torch.from_numpy(arrays[n]), mesh,
                placements(mesh, specs[n.split("/")[1]]))
                for n in arrays.files if n.startswith(key + "/")}}
            p = TM.MoEParams(**{{n: d[n] for n in TM.MoEParams.fields}})
            sh = L.MLPParams(**{{n: d[n] for n in L.MLPParams.fields}}) \\
                if cfg.moe.n_shared else None
            with torch.no_grad():
                y = TM.moe_forward(cfg, p, d["x"], shared_mlp=sh, mesh=mesh,
                                   batch_axes=("data",))
            out[key] = y.full_tensor().numpy()
        if rank == 0:
            np.savez({path!r}, **out)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(rank_main, args=({init!r},), nprocs=4, join=True)
""")


@pytest.fixture(scope="module")
def four_rank_runs():
    """Both packages' outputs at 4 devices, each from its own subprocess
    (run side by side)."""
    tests = os.path.join(ROOT, "tests")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), tests,
         os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "ref.npz")
        port_path = os.path.join(tmp, "port.npz")
        port_script = os.path.join(tmp, "port.py")
        inputs = os.path.join(tmp, "inputs.npz")
        cases = os.path.join(tmp, "cases.json")
        # the ranks get the seeded arrays from a file (they import no jax)
        np.savez(inputs, **{f"{shape}-{arch}-{cf}/{n}": v
                            for shape, arch, cf in CASES_4
                            for n, v in _arrays(_cfgs(arch, cf)[0],
                                                seed=12).items()})
        with open(cases, "w") as f:
            json.dump(CASES_4, f)
        with open(port_script, "w") as f:
            f.write(_PORT.format(path=port_path, inputs=inputs, cases=cases,
                                 init=os.path.join(tmp, "pg")))
        procs = [
            subprocess.Popen([sys.executable, "-c", _REF.format(
                tests=tests, path=ref_path)], env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            subprocess.Popen([sys.executable, port_script], env=env,
                             text=True, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT),
        ]
        for proc in procs:
            out, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, out[-4000:]
        yield dict(np.load(ref_path)), dict(np.load(port_path))


@pytest.mark.parametrize("shape,arch,cf", CASES_4)
def test_moe_ep_four_ranks(four_rank_runs, shape, arch, cf):
    ref, port = four_rank_runs
    key = f"{shape}-{arch}-{cf}"
    diff = _close(port[key], ref[key])
    print(f"moe_forward {key}: max |diff| {diff:.3g}")
    cfg_r, cfg_t = _cfgs(arch, cf)
    a = _arrays(cfg_r, seed=12)
    keep_r = _ref_keep(cfg_r, a, shape[0])
    keep_t = _port_keep(cfg_t, a, shape[0])
    for r, t in zip(keep_r, keep_t):
        np.testing.assert_array_equal(t, r)
    dropped = sum(int((~k).sum()) for k in keep_r)
    # the factors straddle the drops: ed x the tokens' pairs never drop
    assert (dropped == 0) == (cf >= shape[0]), dropped


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q", "-s"]))
