"""Multi-pod dry run: trace every (architecture x input shape) cell on the
production mesh and record per-device memory, FLOPs and collective traffic
for §Roofline.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell for 256 / 512 forced host devices.  Here the mesh is a ``DeviceMesh``
over a ``fake`` process group of 256 / 512 ranks in one process (rank 0),
and the parameters, optimizer state and inputs are ``DTensor``s whose
shards are fake tensors: nothing is allocated on any device and no
collective moves data.  One call of the cell's step (a train step, a
prefill, a decode step) runs on them, and three dispatch modes watch the
ops that rank 0 runs on its shards:

* ``flops``: FlopCounterMode's formulas over those local ops, so per
  device, not the global product (a ``DTensor`` op is skipped: its shards'
  ops are counted).  ``torch._grouped_mm`` has no formula in torch; it is
  counted as 2·M·K·N over every row of its capacity-bounded buffer (the
  groups' sizes are data, which fake tensors do not hold).  A train record
  counts one microbatch and one optimizer update: ``microbatches``
  says how many a step takes, and ``roofline.analyze`` scales by it, as the
  reference's XLA counts the accumulation loop's body once.
* ``bytes_accessed``: the bytes every local op that is not a view reads and
  writes (inputs and outputs, before any fusion).
* ``temp_size_in_bytes``: the peak of the bytes held by the tensors the
  step creates (activations, gradients, buffers, collective outputs), from
  the storages of the local ops' outputs.
* ``collectives``: ``hlo_stats.CollectiveTally`` (CommDebugMode).

``argument_size_in_bytes`` and ``output_size_in_bytes`` are the bytes of
rank 0's shards of the step's arguments and results, exactly.  ``lower_s``
is the trace's wall seconds; nothing is compiled (``compile_s`` 0).  The
layer loop is a Python loop, so every layer is counted
(``flops_from_unrolled``).  Every number is a count of a model of the run,
not a measurement.  Each record names the torch that counted it
(``torch_version``): the counts rest on that version's FLOP formulas and on
private DTensor hooks, and ``roofline.load`` refuses to mix versions.

The ``batann-serve`` cells do not trace: the port's SPMD body syncs with the
host and loops on data.  Their records hold rank 0's argument bytes from the
``DeviceState`` / ``Shard`` shapes and the bytes of one super-step's
collectives from its send buffers' shapes (``"derived": true``); FLOPs are
NaN.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import hlo_stats, shardings as sh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.config import SHAPES, applicable_shapes
from repro_torch.models.layers import placements
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.train_loop import TrainConfig, make_train_step

ARTIFACTS = os.path.join(os.path.dirname(__file__),
                         "../../../artifacts/dryrun_torch")

# params >= this use bf16 params + bf16 adam moments for train cells
_BF16_TRAIN_THRESHOLD = 100e9
# per-arch grad-accumulation microbatches for train_4k (activation fit)
_MICROBATCHES = {
    "qwen3-14b": 4, "gemma3-27b": 8, "kimi-k2-1t-a32b": 8,
    "grok-1-314b": 8, "musicgen-large": 2, "internvl2-2b": 2,
}

COUNTED = {
    "flops": "per device: FlopCounterMode formulas over rank 0's local ops; "
             "torch._grouped_mm as 2*M*K*N over every buffer row",
    "bytes_accessed": "per device: bytes read and written by rank 0's "
                      "local ops that are not views, unfused",
    "temp_size_in_bytes": "per device: peak bytes of the storages the step "
                          "creates on rank 0",
    "collectives": "per device: output bytes of each collective on rank 0 "
                   "(CommDebugMode)",
    "hlo_instructions": "local ops rank 0 dispatched (no HLO in torch)",
    "lower_s": "wall seconds of the trace on fake tensors",
    "generated_code_size_in_bytes": "0: nothing is compiled",
    "torch_version": f"the torch that counted ({torch.__version__}): the "
                     "counts rest on its FLOP formulas and on private "
                     "DTensor internals that outside_propagation patches "
                     "(propagate_op_sharding_non_cached, _StridedShard."
                     "local_shard_size_and_offset), "
                     "so records of two versions are not comparable",
}


def _grouped_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs):
    """(M, K) x (G, K, N) with every row in some group: 2·M·K·N."""
    m, k = a_shape[-2:]
    return 2 * m * k * b_shape[-1]


def _flop_registry():
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten._grouped_mm: _grouped_mm_flops}).flop_registry


def _tensors(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


class LocalCounter(TorchDispatchMode):
    """FLOPs, bytes accessed, op count and the peak bytes of the storages
    created, over the ops run on local (non-``DTensor``) tensors.  A
    ``DTensor`` op returns NotImplemented here, so ``DTensor`` runs it and
    its ops on the shards come back through this mode.  ``paused`` > 0
    while ``DTensor`` infers an output's global shape by running the op on
    global-shaped fake tensors (:func:`outside_propagation`)."""

    def __init__(self):
        super().__init__()
        self.registry = _flop_registry()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.paused = 0
        self._seen = WeakIdKeyDictionary()

    def _drop(self, n, _ref):
        self.live -= n

    def _track(self, t):
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = weakref.ref(st, lambda r, n=n: self._drop(n, r))
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        self.ops += 1
        f = self.registry.get(func._overloadpacket)
        if f is not None:
            self.flops += int(f(*args, **kwargs, out_val=out))
        outs = _tensors(out)
        if outs and not any(o._is_view() for o in outs):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _tensors((args, kwargs)) + outs)
            for o in outs:
                self._track(o)
        return out


@contextlib.contextmanager
def outside_propagation(counter: LocalCounter):
    """Pause ``counter`` while ``DTensor``'s sharding propagator picks an
    op's strategy and infers its output's shape (by running the op on
    global-shaped fake tensors), and while a ``_StridedShard`` computes its
    local size; run the latter with the fake mode off, as it makes index
    tensors and reads them on the host (which fake tensors cannot).  Both
    methods are wrapped for the block."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard

    def paused(inner, no_fake=False):
        def fn(*args, **kwargs):
            counter.paused += 1
            try:
                if no_fake:
                    with unset_fake_temporarily():
                        return inner(*args, **kwargs)
                return inner(*args, **kwargs)
            finally:
                counter.paused -= 1
        return fn

    prop = DTensor._op_dispatcher.sharding_propagator
    name = "propagate_op_sharding_non_cached"
    size_fn = _StridedShard.local_shard_size_and_offset
    setattr(prop, name, paused(getattr(prop, name)))
    _StridedShard.local_shard_size_and_offset = paused(size_fn, no_fake=True)
    try:
        yield
    finally:
        delattr(prop, name)
        _StridedShard.local_shard_size_and_offset = size_fn


@contextlib.contextmanager
def fake_world(world: int):
    """A ``fake`` default process group of ``world`` ranks (this process is
    rank 0): collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in _tensors(tree))


def _place(tree, mesh, specs):
    """Meta tensors -> fake ``DTensor``s at their specs' placements (a
    dict, a ``Caches`` or a model)."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        return distribute_tensor(torch.zeros(t.shape, dtype=t.dtype), mesh,
                                 placements(mesh, spec))

    if isinstance(tree, dict):
        return {k: one(v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, T.Caches):
        return T.Caches(*(None if t is None else one(t, s)
                          for t, s in zip(tree, specs)))
    return sh.place_params(tree, mesh, specs,
                           leaf=lambda w: torch.zeros(w.shape, dtype=w.dtype))


def _train_cell(cfg, shape, mesh, multi_pod, variant="baseline"):
    big = cfg.param_count() >= _BF16_TRAIN_THRESHOLD
    zero2 = variant == "zero2"
    param_dtype = torch.bfloat16 if (big or zero2) else torch.float32
    moment_dtype = "bfloat16" if big else "float32"
    cell = sh.make_cell_sharding(cfg, shape, mesh, multi_pod)
    mspecs = cell.param_specs
    if zero2:
        cell.param_specs = sh.make_param_specs(cfg, mesh, multi_pod,
                                               zero2=True)
    ctx = T.RunCtx(
        ax=cell.rules, mesh=mesh, batch_axes=cell.batch_axes,
        compute_dtype=torch.bfloat16, remat=True, attn_chunk=4096,
        scan_unroll=True,
    )
    mb = _MICROBATCHES.get(cfg.name, 1)
    opt = opt_mod.AdamWConfig(moment_dtype=moment_dtype)
    params = _place(T.abstract_params(cfg, param_dtype), mesh,
                    cell.param_specs).requires_grad_(True)
    m_dt = opt_mod._DTYPES[moment_dtype]
    # moments keep the data-sharded (ZeRO) layout under zero2
    moments = [_place(T.abstract_params(cfg, m_dt), mesh,
                      mspecs).requires_grad_(False) for _ in range(2)]
    opt_state = opt_mod.OptState(step=0, m=moments[0], v=moments[1])
    batch, bspecs = sh.input_specs(cfg, shape, mesh, multi_pod)
    b_micro = shape.global_batch // mb
    micro = _place({k: torch.empty((b_micro,) + v.shape[1:], dtype=v.dtype,
                                   device="meta")
                    for k, v in batch.items()}, mesh, bspecs)
    state_bytes = sum(_local_bytes(m) for m in [params] + moments)
    arg_bytes = state_bytes + _local_bytes(_place(batch, mesh, bspecs))
    step = make_train_step(cfg, TrainConfig(batch=b_micro,
                                            seq_len=shape.seq_len, opt=opt),
                           ctx)
    return (lambda: step(params, opt_state, micro)), arg_bytes, \
        lambda out: state_bytes


def _prefill_cell(cfg, shape, mesh, multi_pod):
    cell = sh.make_cell_sharding(cfg, shape, mesh, multi_pod)
    ctx = T.RunCtx(
        ax=cell.rules, mesh=mesh, batch_axes=cell.batch_axes,
        compute_dtype=torch.bfloat16, attn_chunk=2048, scan_unroll=True,
    )
    params = _place(T.abstract_params(cfg, torch.bfloat16), mesh,
                    cell.param_specs)
    batch, bspecs = sh.input_specs(cfg, shape, mesh, multi_pod)
    batch = _place(batch, mesh, bspecs)
    arg_bytes = _local_bytes(params) + _local_bytes(batch)
    return (lambda: T.prefill(cfg, params, batch, shape.seq_len, ctx)), \
        arg_bytes, _local_bytes


def _decode_cell(cfg, shape, mesh, multi_pod, variant="baseline"):
    cell = sh.make_cell_sharding(cfg, shape, mesh, multi_pod)
    ctx = T.RunCtx(
        ax=cell.rules, mesh=mesh, batch_axes=cell.batch_axes,
        compute_dtype=torch.bfloat16, scan_unroll=True,
        grouped_gqa=(variant == "grouped"),
    )
    params = _place(T.abstract_params(cfg, torch.bfloat16), mesh,
                    cell.param_specs)
    batch, bspecs = sh.input_specs(cfg, shape, mesh, multi_pod)
    batch = _place(batch, mesh, bspecs)
    caches, cspecs = sh.cache_specs(cfg, shape, mesh, multi_pod)
    caches = _place(caches, mesh, cspecs)
    arg_bytes = (_local_bytes(params) + _local_bytes(batch)
                 + _local_bytes(list(caches)))
    tok = batch if cfg.frontend else batch["tokens"]
    # the last position: every cache row is live (any t costs the same)
    t = shape.seq_len - 1
    return (lambda: T.decode_step(cfg, params, tok, t, caches, ctx)), \
        arg_bytes, _local_bytes


def _batann_record(n_dev: int, sector: bool = False) -> dict:
    """Rank 0's argument bytes and one super-step's collective bytes of the
    SPMD baton search over ``n_dev`` partitions, from the shapes
    ``launch/spmd.py`` runs (``DeviceState`` and ``Shard`` of one rank;
    the want/free all_gather, the two all_to_alls of the state and result
    send buffers, the remaining-count all_reduce)."""
    from repro_torch.configs.batann_serve import CONFIG as BC
    from repro_torch.core import baton
    from repro_torch.core.state import N_STATS, N_TRACE, empty_state

    meta = torch.device("meta")
    cfg = baton.BatonParams(
        L=BC.L, W=BC.W, k=BC.k, pool=BC.pool, slots=BC.slots,
        pair_cap=BC.pair_cap, result_cap=BC.result_cap,
        n_starts=BC.n_starts, max_supersteps=64)
    n_local = BC.n_total // n_dev
    q = cfg.slots              # one refill's worth of queued queries
    d, m, k_pq, r = BC.dim, BC.pq_m, BC.pq_k, BC.graph_r

    def e(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=meta)

    i32, f32, u8 = torch.int32, torch.float32, torch.uint8
    dev = baton.DeviceState(
        states=empty_state(d, cfg.L, cfg.pool, m=m, k_pq=k_pq,
                           trace_cap=cfg.trace_cap, shape=(1, cfg.slots),
                           device=meta),
        queue_emb=e((1, q, d), f32), queue_qid=e((1, q), i32),
        queue_starts=e((1, q, cfg.n_starts), i32),
        queue_start_d=e((1, q, cfg.n_starts), f32),
        queue_lut=e((1, q, m, k_pq), f32), queue_head=e((1,), i32),
        out_ids=e((1, q, cfg.k), i32), out_dists=e((1, q, cfg.k), f32),
        out_stats=e((1, q, N_STATS), i32),
        out_trace=e((1, q, cfg.trace_cap, N_TRACE), i32),
        delivered=e((1, q), torch.bool))
    if sector:
        shard = [e((n_local, d), u8), e((n_local, r), i32), e((1, m), u8),
                 e((BC.n_total,), u8), e((BC.n_total,), i32),
                 e((n_local, r, m), u8)]
    else:
        shard = [e((n_local, d), f32), e((n_local, r), i32),
                 e((BC.n_total, m), u8), e((BC.n_total,), i32),
                 e((BC.n_total,), i32)]
    codebook = e((m, k_pq, d // m), f32)
    sends = empty_state(d, cfg.L, cfg.pool, trace_cap=cfg.trace_cap,
                        shape=(1, n_dev, cfg.pair_cap), device=meta)
    results = baton._empty_results(cfg, (1, n_dev, cfg.result_cap), meta)
    a2a = _local_bytes(list(sends)) + _local_bytes(list(results))
    coll = {
        "all-gather": {"count": 1, "bytes": n_dev * (n_dev + 1) * 4},
        "all-to-all": {"count": 2, "bytes": a2a},
        "all-reduce": {"count": 1, "bytes": 8},
    }
    coll["total"] = {"count": sum(v["count"] for v in coll.values()),
                     "bytes": sum(v["bytes"] for v in coll.values())}
    return {
        "flops": float("nan"), "bytes_accessed": float("nan"),
        "collectives": coll, "hlo_instructions": 0,
        "argument_size_in_bytes": _local_bytes(list(dev))
        + _local_bytes(shard) + _local_bytes([codebook]),
        "derived": True,
        "counted": {"argument_size_in_bytes": "rank 0's DeviceState, Shard "
                    "and codebook bytes from their shapes",
                    "collectives": "one super-step's collectives from their "
                    "send buffers' shapes (derived, not traced)"},
    }


def trace_cell(cfg, shape, mesh, multi_pod: bool,
               variant: str = "baseline") -> dict:
    """Trace one LM cell on ``mesh`` (over an initialised process group)
    and return its counts: the record's measured keys (module docstring)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    with FakeTensorMode(), implicit_replication():
        if shape.kind == "train":
            run, arg_bytes, out_bytes = _train_cell(cfg, shape, mesh,
                                                    multi_pod, variant)
        elif shape.kind == "prefill":
            run, arg_bytes, out_bytes = _prefill_cell(cfg, shape, mesh,
                                                      multi_pod)
        else:
            run, arg_bytes, out_bytes = _decode_cell(cfg, shape, mesh,
                                                     multi_pod, variant)
        counter = LocalCounter()
        tally = hlo_stats.CollectiveTally()
        t0 = time.perf_counter()
        with outside_propagation(counter), tally, counter:
            out = run()
        t_trace = time.perf_counter() - t0
        out_b = out_bytes(out)
    return {
        "lower_s": round(t_trace, 1),
        "compile_s": 0.0,
        "flops": float(counter.flops),
        "bytes_accessed": float(counter.bytes),
        "collectives": hlo_stats.collective_stats(tally.seen),
        "hlo_instructions": counter.ops,
        "flops_from_unrolled": True,
        "argument_size_in_bytes": int(arg_bytes),
        "output_size_in_bytes": int(out_b),
        "temp_size_in_bytes": int(counter.peak),
        "generated_code_size_in_bytes": 0,
        "counted": COUNTED,
    }


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def cell_record(arch: str, cfg, shape, mesh, multi_pod: bool,
                variant: str = "baseline") -> dict:
    """The record of one LM cell (the reference's keys): ``trace_cell``'s
    counts on ``mesh`` (over an initialised process group)."""
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name(mesh),
           "n_devices": mesh.size(),
           **trace_cell(cfg, shape, mesh, multi_pod, variant),
           "microbatches": _MICROBATCHES.get(arch, 1)
           if shape.name == "train_4k" else 1,
           "input_shape": dataclasses.asdict(shape),
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count(),
           "variant": variant, "torch_version": torch.__version__}
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             verbose: bool = True, skip_unroll: bool = False,
             variant: str = "baseline") -> dict:
    """Trace one production cell over a fake group of 256 / 512 ranks and
    write its record to ``out_dir``.  ``skip_unroll`` is taken for the
    reference's CLI and changes nothing (the port's loop is unrolled)."""
    cfg = None if arch == "batann-serve" else get_config(arch)
    if cfg is not None and shape_name not in applicable_shapes(cfg):
        return {"arch": arch, "shape": shape_name, "skipped": True}
    n_dev = 512 if multi_pod else 256
    if cfg is None:
        rec = {"arch": arch, "shape": shape_name,
               "mesh": "2x16x16" if multi_pod else "16x16",
               "n_devices": n_dev, "lower_s": 0.0, "compile_s": 0.0,
               **_batann_record(n_dev, sector=(shape_name == "serve-sector")),
               "microbatches": 1, "flops_from_unrolled": False,
               "variant": variant, "torch_version": torch.__version__}
    else:
        if variant == "headpad48":
            # pad attention heads to the next TP multiple (an A/B label)
            cfg = dataclasses.replace(cfg, n_heads=48)
        with fake_world(n_dev):
            mesh = make_production_mesh(multi_pod=multi_pod)
            rec = cell_record(arch, cfg, SHAPES[shape_name], mesh, multi_pod,
                              variant)
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}_{shape_name}_{rec['mesh'].replace('x', '-')}"
    if variant != "baseline":
        tag += f"_{variant}"
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        coll = rec["collectives"]["total"]["bytes"]
        print(f"[dryrun] {tag}: OK flops={rec['flops']:.3e} "
              f"coll={coll / 1e6:.1f}MB/dev trace={rec['lower_s']:.1f}s")
        print("  memory:", {k: rec[k] for k in rec
                            if k.endswith("_in_bytes")})
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.normpath(ARTIFACTS))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--skip-unroll", action="store_true",
                    help="taken for the reference's CLI; no effect")
    ap.add_argument("--variant", default="baseline",
                    help="baseline | zero2 | grouped | headpad48")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh]
    cells = []
    if args.all:
        for arch in ARCH_IDS:
            if arch == "batann-serve":
                cells.append((arch, "serve"))
                cells.append((arch, "serve-sector"))
                continue
            for s in applicable_shapes(get_config(arch)):
                cells.append((arch, s))
    else:
        if not args.arch:
            ap.error("--arch or --all required")
        shapes = [args.shape] if args.shape else (
            ["serve"] if args.arch == "batann-serve"
            else applicable_shapes(get_config(args.arch)))
        cells = [(args.arch, s) for s in shapes]

    failures = []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}_{shape}_{'2-16-16' if mp else '16-16'}"
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[dryrun] {tag}: cached")
                continue
            try:
                run_cell(arch, shape, mp, args.out,
                         skip_unroll=args.skip_unroll, variant=args.variant)
            except Exception as e:  # noqa: BLE001 -- report every cell
                traceback.print_exc()
                failures.append((tag, str(e)[:200]))
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for t, e in failures:
            print("  ", t, e)
        raise SystemExit(1)
    print("[dryrun] all cells OK")


if __name__ == "__main__":
    main()
