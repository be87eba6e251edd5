"""Run the baton search SPMD: one partition per process, over gloo.

    from repro_torch.launch import spmd
    [(ids, dists, stats)] = spmd.search(index_dir, queries, [cfg], world=P,
                                        device="cpu")   # default "cuda"

The paper's execution model (the reference's ``core/baton.py::
make_spmd_fn`` under ``shard_map``, driven by ``examples/
distributed_search.py``): ``world = P`` ranks, rank r owning partition r,
the baton hand-off a real ``all_to_all`` between processes.  ``search``
spawns the ranks with ``torch.multiprocessing`` (spawn, never fork); they
meet at a ``file://`` rendezvous in a temporary directory with a timeout,
so a mismatch fails instead of hanging.  Each rank loads the index that
``Deployment.save`` wrote to ``directory``, keeping on its device only its own
partition's vectors and neighbours (plus the replicated codes, maps,
codebook and head index), on ``cuda:(rank % device_count)`` — every rank
on the one card of a one-card machine — or on the CPU when asked.  The
collectives go over gloo on host tensors: one card cannot host two NCCL
ranks, and the paper hands batons over TCP.

The kernel libraries are built before any rank starts; each rank only
loads them, once for any number of search configurations.  Rank 0
returns ``run_simulated``'s ``(ids, dists, stats)`` for each, with
``stats["ranks"]`` holding every rank's kernel launch counts, host syncs
and start-up, load, warm-up and run seconds.  A rank that raises makes ``search`` raise
(``torch.multiprocessing.ProcessRaisedException``; the other ranks are
terminated).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import kernels
from repro_torch.api.deployment import _restore_index
from repro_torch.core import baton, vamana
from repro_torch.device import SyncMeter, resolve_device, synchronize

RESULT_FILE = "rank0.pkl"


def load_rank_index(directory: str, rank: int, device) -> baton.BatonIndex:
    """Rank ``rank``'s view of the baton index saved under ``directory``:
    partition ``rank``'s vectors and neighbours as the one row of the
    per-partition leaves, the replicated leaves whole, all on ``device``;
    the global graph, which search does not read, stays on the host, and a
    sector layout's ``part_nbr_codes`` are not loaded (the ranks score
    with the replicated codes)."""
    tree, meta = _restore_index(directory)
    if rank >= meta["p"]:
        raise ValueError(f"rank {rank} of an index with P={meta['p']}")

    def t(name, rows=None):
        a = np.asarray(tree[name])
        return torch.from_numpy(a if rows is None else a[rows]).to(device)

    mine = slice(rank, rank + 1)
    return baton.BatonIndex(
        n=meta["n"], p=meta["p"], dim=meta["dim"],
        part_vectors=t("part_vectors", mine),
        part_neighbors=t("part_neighbors", mine),
        codes=t("codes"), codebook=t("codebook"),
        node2part=t("node2part"), node2local=t("node2local"),
        head_vectors=t("head_vectors"), head_neighbors=t("head_neighbors"),
        head_sample_ids=t("head_sample_ids"),
        head_medoid=meta["head_medoid"],
        assign=np.asarray(tree["assign"], np.int32),
        graph=vamana.VamanaGraph(
            neighbors=torch.from_numpy(np.asarray(tree["graph_neighbors"])),
            medoid=meta["graph_medoid"], R=meta["graph_R"],
            L_build=meta["graph_L_build"], alpha=meta["graph_alpha"]),
    )


def _rank_main(rank, world, directory, queries_path, cfgs, device,
               t_spawn):
    """One rank of ``search``: load its partition, then for each config
    warm up and run ``run_spmd`` once; rank 0 returns the results, each
    with every rank's record."""
    t_group = time.time()
    queries = np.load(queries_path)
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    index = load_rank_index(directory, rank, dev)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        for name in _build.SOURCES:
            _build.load(name)
    synchronize(dev)
    load_s = time.perf_counter() - t0
    results = []
    for cfg in cfgs:
        # warm-up off the clock: one query per partition
        t0 = time.perf_counter()
        baton.run_spmd(index, queries[:world], cfg, rank, world)
        synchronize(dev)
        warm_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        meter = SyncMeter()
        dist.barrier()
        t0 = time.perf_counter()
        result = baton.run_spmd(index, queries, cfg, rank, world,
                                meter=meter)
        synchronize(dev)
        record = {"rank": rank, "device": str(dev),
                  "launches": kernels.launch_counts(),
                  "host_syncs": meter.count, "host_sync_s": meter.seconds,
                  "start_s": t_group - t_spawn, "load_s": load_s,
                  "warm_s": warm_s, "run_s": time.perf_counter() - t0}
        records = [None] * world if rank == 0 else None
        dist.gather_object(record, records, dst=0)
        if rank == 0:
            result[2]["ranks"] = records
        results.append(result)
    return results


def _rank_entry(rank, fn, world, init_method, out_dir, timeout_s, args):
    """Join the gloo group, run ``fn(rank, world, *args)``, leave the
    group; rank 0 pickles what ``fn`` returned into ``out_dir``."""
    # the ranks share the host's cores
    torch.set_num_threads(1)
    # one host: the ranks talk over loopback TCP
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, world, *args)
        if rank == 0:
            with open(os.path.join(out_dir, RESULT_FILE), "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, args: tuple = (), timeout_s: float = 600.0):
    """Run ``fn(rank, world, *args)`` on ``world`` spawned processes joined
    in one gloo group (a ``file://`` rendezvous in a temporary directory;
    ``timeout_s`` bounds every collective) and return what rank 0's
    returned.  ``fn`` must be importable by name (spawn pickles it).  A
    rank that raises makes this raise ``ProcessRaisedException`` once the
    others are terminated."""
    with tempfile.TemporaryDirectory(prefix="spmd_") as tmp:
        torch.multiprocessing.spawn(
            _rank_entry, nprocs=world, join=True,
            args=(fn, world, "file://" + os.path.join(tmp, "rendezvous"),
                  tmp, timeout_s, args))
        with open(os.path.join(tmp, RESULT_FILE), "rb") as f:
            return pickle.load(f)


def search(directory: str, queries, cfgs, world: int, device="cuda",
           timeout_s: float = 600.0) -> list:
    """Answer ``queries`` once for each ``BatonParams`` in ``cfgs`` on
    ``world`` spawned ranks (one spawn for all of them) over the baton
    index saved under ``directory`` (``Deployment.save``; its P must equal
    ``world``).  Returns rank 0's ``(ids, dists, stats)`` for each config:
    what ``baton.run_simulated`` returns, plus ``stats["ranks"]`` (each
    rank's launches and host syncs in the run, and its seconds from the
    spawn to joining the group, to load, to warm up and to run) and
    ``stats["wall_s"]`` (this call, spawning included)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.build()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="spmd_queries_") as tmp:
        # a file, not a spawn argument: spawn arguments beyond a pipe's
        # buffer block each start() until that rank has booted
        path = os.path.join(tmp, "queries.npy")
        np.save(path, np.asarray(queries, np.float32))
        results = spawn_ranks(
            _rank_main, world, (directory, path, list(cfgs), dev.type,
                                time.time()), timeout_s)
    wall_s = time.perf_counter() - t0
    for _, _, stats in results:
        stats["wall_s"] = wall_s
    return results
