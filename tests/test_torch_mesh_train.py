"""Gradients of the model on a 4-rank mesh against the reference's.

qwen2-smoke (dense; its embedding table vocab-sharded over ``model``) and
grok-smoke (``moe_ep``: the router replicated, the experts over ``data``) at
(data, model) = (4, 1) and (2, 2), and qwen2-smoke with 3 query heads and 1
KV head at (2, 2) (heads that do not divide ``model``: context-parallel
attention, K/V replicated over ``model`` while the queries are
sequence-sharded there, as qwen2-0.5b's 14 heads are over 16).  Seeded
weights at ``tests/_lm.py``'s scales carried across, the parameters, batch
and rules placed by ``launch/shardings.py``.  Each rank holds a part of the
batch (or of the queries), so a parameter or input replicated over a mesh
axis whose gradient a rank computes from its own part only (the router,
the embedding table, K/V) must be summed over that axis.

* The port at 4 gloo ranks, spawned from a subprocess: the loss and every
  gradient leaf of ``loss_fn`` (``torch.autograd.grad`` under
  ``mesh_scope``), then one ``make_train_step`` from the same state.
* The reference on 4 forced host devices in another subprocess (as
  ``tests/test_spmd.py`` runs it): ``jax.value_and_grad(loss_fn)`` under
  ``jax.jit`` with the same rules and shardings.

The loss within rtol 1e-5, every gradient leaf within rtol 1e-4 / atol 1e-5
of the reference's; the parameters after the meshed step within rtol 1e-4 /
atol 1e-5 of the unmeshed step's, and each replicated parameter the same on
every rank, bit for bit.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import tempfile
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as RT
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as TT
from repro_torch.training import optimizer as TO
from repro_torch.training.train_loop import TrainConfig, make_train_step

import _lm
from _lm import close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# model name -> (smoke config, the fields it changes)
MODELS = {"qwen2-0.5b": ("qwen2-0.5b", {}),
          "grok-1-314b": ("grok-1-314b", {}),
          "qwen2-cp": ("qwen2-0.5b", {"n_heads": 3, "n_kv_heads": 1})}
CASES = [(shape, m) for shape in ((4, 1), (2, 2))
         for m in ("qwen2-0.5b", "grok-1-314b")] + [((2, 2), "qwen2-cp")]
B, S = 4, 16


@functools.lru_cache(maxsize=None)
def models(name: str):
    """``_lm.models`` for a model of :data:`MODELS`: (reference cfg,
    reference params, port cfg, port params)."""
    arch, fields = MODELS[name]
    if not fields:
        return _lm.models(arch)
    rcfg = dataclasses.replace(_lm.rreg.get_smoke_config(arch), **fields)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: _lm._leaf(rng, path, a.shape),
        RT.abstract_params(rcfg))
    tcfg = dataclasses.replace(treg.get_smoke_config(arch), **fields)
    return (rcfg, jax.tree.map(jax.numpy.asarray, tree), tcfg,
            TT.params_from_tree(tcfg, tree, device="cpu"))


def _batch(cfg, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(2, B, S)).astype(np.int32)
    return {"tokens": toks[0], "labels": toks[1]}


_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    sys.path.insert(0, {tests!r})
    import test_torch_mesh_train as t
    from repro.launch import shardings as RS
    from repro.models import transformer as RT
    from repro.models.config import InputShape
    out = {{}}
    for shape, arch in t.CASES:
        rcfg, rp, _, _ = t.models(arch)
        mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(
            jax.sharding.AxisType.Auto,) * 2)
        ishape = InputShape("t", t.S, t.B, "train")
        cell = RS.make_cell_sharding(rcfg, ishape, mesh, False)
        _, bsh = RS.input_specs(rcfg, ishape, mesh, False)
        ctx = RT.RunCtx(ax=cell.rules, mesh=mesh,
                        batch_axes=cell.batch_axes)
        f = jax.jit(jax.value_and_grad(
            lambda p, b: RT.loss_fn(rcfg, p, b, ctx)),
            in_shardings=(RS.named(mesh, cell.param_specs), bsh))
        loss, grads = f(rp, {{k: jnp.asarray(v)
                             for k, v in t._batch(rcfg).items()}})
        key = f"{{shape}}-{{arch}}"
        out[key + "/loss"] = np.asarray(loss)
        for i, g in enumerate(jax.tree.leaves(grads)):
            out[f"{{key}}/{{i}}"] = np.asarray(g)
    np.savez({path!r}, **out)
""")

_PORT = textwrap.dedent("""
    import dataclasses, json
    import numpy as np, torch, torch.distributed as dist
    import torch.multiprocessing as mp

    MODELS = {models!r}

    def rank_main(rank, init):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.configs.registry import get_smoke_config
        from repro_torch.launch import shardings as TS
        from repro_torch.models import transformer as T
        from repro_torch.models.config import InputShape
        from repro_torch.models.layers import placements
        from repro_torch.training import optimizer as O
        from repro_torch.training.train_loop import TrainConfig, \\
            make_train_step
        torch.set_num_threads(1)       # four ranks share the host's cores
        dist.init_process_group("gloo", init_method="file://" + init,
                                rank=rank, world_size=4)
        weights = torch.load({weights!r})
        batches = np.load({batches!r})
        out = {{}}
        for shape, arch in json.load(open({cases!r})):
            key = f"{{tuple(shape)}}-{{arch}}"
            base, fields = MODELS[arch]
            cfg = dataclasses.replace(get_smoke_config(base), **fields)
            mesh = init_device_mesh("cpu", tuple(shape),
                                    mesh_dim_names=("data", "model"))
            ishape = InputShape("t", {S}, {B}, "train")
            cell = TS.make_cell_sharding(cfg, ishape, mesh, False)
            _, bspecs = TS.input_specs(cfg, ishape, mesh, False)
            plain = T.init_params(cfg, device="cpu")
            plain.load_state_dict(weights[arch])
            params = TS.place_params(plain, mesh, cell.param_specs
                                     ).requires_grad_(True)
            batch = {{k: distribute_tensor(
                torch.from_numpy(batches[arch + "/" + k]), mesh,
                placements(mesh, bspecs[k])) for k in ("tokens", "labels")}}
            ctx = T.RunCtx(ax=cell.rules, mesh=mesh,
                           batch_axes=cell.batch_axes)
            plist = list(params.parameters())
            tcfg = TrainConfig(batch={B}, seq_len={S})
            st = O.init(tcfg.opt, plain)
            state = O.OptState(
                step=0, m=TS.place_params(st.m, mesh, cell.param_specs),
                v=TS.place_params(st.v, mesh, cell.param_specs))
            state.m.requires_grad_(False)
            state.v.requires_grad_(False)
            with T.mesh_scope(ctx):
                loss = T.loss_fn(cfg, params, batch, ctx)
                grads = torch.autograd.grad(loss, plist)
                out[key + "/loss"] = loss.full_tensor().detach().numpy()
                for i, g in enumerate(grads):
                    out[f"{{key}}/grad/{{i}}"] = g.full_tensor().numpy()
                make_train_step(cfg, tcfg, ctx)(params, state, batch)
            same = True
            for i, w in enumerate(params.parameters()):
                local = w.to_local().detach()
                if all(p.is_replicate() for p in w.placements):
                    seen = [torch.empty_like(local) for _ in range(4)]
                    dist.all_gather(seen, local)
                    same &= all(torch.equal(s, local) for s in seen)
                out[f"{{key}}/param/{{i}}"] = w.full_tensor().detach().numpy()
            out[key + "/replicas_equal"] = np.asarray(same)
        if rank == 0:
            np.savez({path!r}, **out)
        dist.barrier()
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(rank_main, args=({init!r},), nprocs=4, join=True)
""")


@pytest.fixture(scope="module")
def four_rank_runs():
    """Both packages' results at 4 devices, each from its own subprocess
    (run side by side)."""
    import json

    tests = os.path.join(ROOT, "tests")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), tests,
         os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        paths = {n: os.path.join(tmp, n) for n in (
            "ref.npz", "port.npz", "port.py", "weights.pt", "batches.npz",
            "cases.json", "pg")}
        # the ranks get the reference's weights and the batches from files
        # (they import no jax)
        torch.save({a: models(a)[3].state_dict() for a in MODELS},
                   paths["weights.pt"])
        np.savez(paths["batches.npz"], **{
            f"{a}/{k}": v for a in MODELS
            for k, v in _batch(models(a)[0]).items()})
        with open(paths["cases.json"], "w") as f:
            json.dump(CASES, f)
        with open(paths["port.py"], "w") as f:
            f.write(_PORT.format(
                path=paths["port.npz"], weights=paths["weights.pt"],
                batches=paths["batches.npz"], cases=paths["cases.json"],
                init=paths["pg"], B=B, S=S, models=MODELS))
        procs = [
            subprocess.Popen([sys.executable, "-c", _REF.format(
                tests=tests, path=paths["ref.npz"])], env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            subprocess.Popen([sys.executable, paths["port.py"]], env=env,
                             text=True, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT),
        ]
        for proc in procs:
            out, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, out[-4000:]
        yield dict(np.load(paths["ref.npz"])), dict(
            np.load(paths["port.npz"]))


def _grad_tree(arch, port, key):
    """The port's gradients (``parameters()`` order) in the reference's
    tree layout, as numpy leaves in its flattening order."""
    tp = models(arch)[3]
    grads = {w: torch.from_numpy(port[f"{key}/grad/{i}"])
             for i, w in enumerate(tp.parameters())}
    grads = TT.map_params(grads.__getitem__, tp)
    return jax.tree.leaves(TT.tree_from_params(models(arch)[2], grads))


@pytest.mark.parametrize("shape,arch", CASES)
def test_gradients_on_four_ranks(four_rank_runs, shape, arch):
    ref, port = four_rank_runs
    key = f"{shape}-{arch}"
    close(port[key + "/loss"], ref[key + "/loss"], rtol=1e-5, atol=0)
    got = _grad_tree(arch, port, key)
    want = [ref[f"{key}/{i}"] for i in range(len(got))]
    assert f"{key}/{len(got)}" not in ref
    worst = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g, w)
        worst = max(worst, float(np.max(np.abs(g - w))))
    print(f"grads {key}: max |diff| {worst:.3g}")


@pytest.mark.parametrize("shape,arch", CASES)
def test_train_step_on_four_ranks(four_rank_runs, shape, arch):
    _, port = four_rank_runs
    key = f"{shape}-{arch}"
    assert bool(port[key + "/replicas_equal"])
    rcfg, _, tcfg, tp = models(arch)
    params = TT.map_params(lambda w: w.detach().clone(), tp
                           ).requires_grad_(True)
    tcfg_train = TrainConfig(batch=B, seq_len=S)
    make_train_step(tcfg, tcfg_train, TT.RunCtx())(
        params, TO.init(tcfg_train.opt, params),
        {k: torch.from_numpy(v) for k, v in _batch(rcfg).items()})
    for i, w in enumerate(params.parameters()):
        close(port[f"{key}/param/{i}"], w.detach())


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q", "-s"]))
