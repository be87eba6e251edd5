"""Per-query execution core for the executable serving tier.

Counterpart of ``repro/serve_async/runtime.py``.  The tier must return
exactly what ``baton.run_simulated`` returns (ids, dists and counters
bitwise, at any worker count), so this module does not reimplement the
search: it drives the engine's own primitives — ``seed_beam_fused``,
``select_frontier``, ``step_disk`` and ``step_disk_batched`` — a query (or a
micro-batch of independent queries) at a time.  A query's trajectory does
not depend on what the other slots do (backpressure only delays a state),
so "advance one state to blocked-or-done on its partition, then hand it to
the owner of its top frontier node" replays the engine's hop sequence.

Where the data lives: a state being advanced lives on the index's device;
``to_host`` brings states back to the host in one transfer (non-blocking
copies ended by one counted sync); the wire transforms ``pack_for_wire`` /
``unpack_from_wire`` turn host states into numpy leaf dicts and back into
device states.  Every loop test of ``advance_state`` / ``advance_batch`` is
one counted device->host sync as well (the reference's ``while_loop``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import pq
from repro_torch.core.beam_search import (
    Shard, seed_beam_fused, select_frontier, step_disk, step_disk_batched,
)
from repro_torch.core.state import (
    INF, NO_ID, STAT_FIELDS, Counters, QueryState, tree_map, where_rows,
)
from repro_torch.device import SyncMeter

I32 = torch.int32
INTER_HOPS_COL = STAT_FIELDS.index("inter_hops")
LUT_BUILDS_COL = STAT_FIELDS.index("lut_builds")


def partition_shard(index, part: int, sector_codes: bool = False) -> Shard:
    """The one-partition view of ``BatonIndex.stacked_shards``: row
    ``part`` of the per-partition leaves (the sector layout's neighbour
    codes too) as a stacked shard of one row (views, no copy), the PQ
    codes (or their sector-layout placeholder) and id maps replicated.
    Callers read its sectors as row 0."""
    sh = index.stacked_shards(sector_codes=sector_codes)
    rows = slice(part, part + 1)
    return sh._replace(
        vectors=sh.vectors[rows], neighbors=sh.neighbors[rows],
        nbr_codes=None if sh.nbr_codes is None else sh.nbr_codes[rows])


def _scalar(value, dtype, device) -> torch.Tensor:
    # a fill kernel, not a host->device copy (which would block)
    return torch.full((), value, dtype=dtype, device=device)


def seed_state(query, starts, start_d, lut, home: int, qid: int, L: int,
               P: int) -> QueryState:
    """Seed one state as ``baton.refill`` does (minus the trace leaf):
    entry-point distances from the head index, missing starts at ``INF``,
    ``lut_builds`` starting at 1 for the build at admission."""
    dev = query.device
    sd = torch.where(starts == NO_ID, INF, start_d)
    bi, bd, be = seed_beam_fused(starts[None], sd[None], L)
    return QueryState(
        query=query, beam_ids=bi[0], beam_dists=bd[0], beam_expl=be[0],
        pool_ids=torch.full((P,), NO_ID, dtype=I32, device=dev),
        pool_dists=torch.full((P,), INF, dtype=torch.float32, device=dev),
        counters=Counters.zeros(device=dev)._replace(
            lut_builds=_scalar(1, I32, dev)),
        active=_scalar(True, torch.bool, dev),
        done=_scalar(False, torch.bool, dev),
        home=_scalar(home, I32, dev), qid=_scalar(qid, I32, dev), lut=lut,
    )


def _ownership(beam_ids, beam_expl, shard: Shard, my_part: int, w: int):
    """``baton._frontier_ownership`` for rows (B, L) living on ``my_part``."""
    fpos, fids, fvalid = select_frontier(beam_ids, beam_expl, w)
    n = shard.node2part.shape[0]
    owner = shard.node2part[fids.clamp(0, n - 1).long()]
    local = fvalid & (owner == my_part)
    dest = torch.where(fvalid[:, 0], owner[:, 0], my_part)
    return fpos, local, local.any(1), fvalid.any(1), dest


def _finish(sts: QueryState, shard: Shard, my_part: int, w: int):
    """Mark finished states done and pick each one's destination."""
    _, _, v = select_frontier(sts.beam_ids, sts.beam_expl, 1)
    sts = sts._replace(done=sts.done | (sts.active & ~v.any(1)))
    *_, dest = _ownership(sts.beam_ids, sts.beam_expl, shard, my_part, w)
    want_move = sts.active & ~sts.done & (dest != my_part)
    return sts, sts.done, torch.where(want_move, dest, my_part).to(I32)


def on_device(tree, device):
    """Every tensor of ``tree`` on ``device``."""
    return tree_map(lambda x: x.to(device), tree)


def advance_state(st: QueryState, shard: Shard, my_part: int, w: int,
                  max_steps: int, meter: "SyncMeter | None" = None):
    """Advance ONE state on ``my_part`` until it blocks on remote data or
    finishes: ``baton.local_advance`` on the per-slot path
    (``step_disk(fused=False)``) plus ``plan_routes``, for one query.  A
    host loop with one sync per step.

    Returns ``(state, done, dest)``; ``dest == my_part`` means the state
    stays resident (done, or ``max_steps`` fired with local work left — the
    caller re-invokes, as the next super-step would).
    """
    meter = meter or SyncMeter()
    st = on_device(st, shard.codes.device)
    for _ in range(max_steps):
        fpos, local, any_local, any_frontier, _ = _ownership(
            st.beam_ids[None], st.beam_expl[None], shard, my_part, w)
        runnable = st.active & ~st.done & any_frontier[0] & any_local[0]
        if not meter.flag(runnable):
            break
        new = step_disk(st, shard, st.lut, local[0], fpos[0], part=0,
                        fused=False)
        _, _, v = select_frontier(new.beam_ids[None], new.beam_expl[None], 1)
        st = new._replace(done=new.done | ~v.any())
    sts, done, dest = _finish(tree_map(lambda x: x[None], st), shard,
                              my_part, w)
    return tree_map(lambda x: x[0], sts), done[0], dest[0]


def stack_states(sts: "list[QueryState]") -> QueryState:
    """Stack independent states leaf-wise onto a leading (B,) axis."""
    return tree_map(lambda *xs: torch.stack(xs), *sts)


def unstack_states(batch: QueryState, n: int) -> "list[QueryState]":
    """Split a stacked batch (on the host, see ``to_host``) into states."""
    return [tree_map(lambda x: x[i], batch) for i in range(n)]


def to_host(trees: tuple, device: torch.device,
            meter: "SyncMeter | None" = None) -> tuple:
    """Copy every tensor of ``trees`` to the host: non-blocking copies,
    then one wait for ``device`` (one counted sync)."""
    out = tuple(tree_map(lambda x: x.to("cpu", non_blocking=True), t)
                for t in trees)
    (meter or SyncMeter()).wait(device)
    return out


def advance_batch(sts: QueryState, shard: Shard, my_part: int, w: int,
                  max_steps: int, adc_impl: str = "gather",
                  merge_impl: str = "lexsort",
                  meter: "SyncMeter | None" = None):
    """:func:`advance_state` over a stacked micro-batch of B independent
    states: one ``step_disk_batched`` per step for the whole batch (one ADC
    call, the engine's own fused step body).

    A state that blocks or finishes is masked out (row select) while the
    rest keep stepping, and "blocked" is stable, so every state takes
    exactly the steps it would take alone: the result equals sequential
    :func:`advance_state` calls (tested bitwise).  Returns
    ``(states, done, dest)`` with leading (B,) axes.
    """
    meter = meter or SyncMeter()
    sts = on_device(sts, shard.codes.device)
    zeros = torch.zeros(sts.active.shape[0], dtype=torch.int64,
                        device=sts.active.device)
    for _ in range(max_steps):
        fposs, local, any_local, any_frontier, _ = _ownership(
            sts.beam_ids, sts.beam_expl, shard, my_part, w)
        runnable = sts.active & ~sts.done & any_frontier & any_local
        if not meter.flag(runnable.any()):
            break
        new = step_disk_batched(
            sts, shard, sts.lut, local & runnable[:, None], fposs, zeros,
            adc_impl=adc_impl, merge_impl=merge_impl)
        _, _, v = select_frontier(new.beam_ids, new.beam_expl, 1)
        new = new._replace(done=new.done | ~v.any(1))
        sts = where_rows(runnable, new, sts)
    return _finish(sts, shard, my_part, w)


def dummy_state(dim: int, cfg, pq_m: int, pq_k: int,
                device: torch.device) -> QueryState:
    """A seeded state with no valid starts (its advance stops at once)."""
    return seed_state(
        torch.zeros((dim,), device=device),
        torch.full((cfg.n_starts,), -1, dtype=I32, device=device),
        torch.full((cfg.n_starts,), INF, device=device),
        torch.zeros((pq_m, pq_k), device=device), 0, 0, cfg.L, cfg.pool)


def warm(shards: dict, cfg, batch: int, dummy: QueryState) -> None:
    """Run every advance variant a worker over ``shards`` ({partition:
    shard}) can run once: the per-state path and each power-of-two batch
    size up to ``batch``, on every partition.  ``dummy`` carries no valid
    start, so each advance stops after its first loop test."""
    for part, shard in shards.items():
        advance_state(dummy, shard, part, cfg.W, cfg.max_local_steps)
        size = 2
        while size <= batch:
            advance_batch(stack_states([dummy] * size), shard, part, cfg.W,
                          cfg.max_local_steps, adc_impl=cfg.adc_impl,
                          merge_impl=cfg.merge_impl)
            size *= 2


def rebuild_lut(codebook: torch.Tensor, query: torch.Tensor,
                lut_impl: str = "einsum") -> torch.Tensor:
    """One query's LUT, rebuilt where it lands (``baton.merge_recv``)."""
    return pq.build_lut(codebook, query[None], impl=lut_impl)[0]


def state_to_host(st: QueryState) -> dict:
    """State -> plain numpy leaf dict (the host-side baton); the leaves,
    dtypes and shapes of the reference's."""
    def h(x):
        return x.cpu().numpy()

    out = {
        "query": h(st.query), "beam_ids": h(st.beam_ids),
        "beam_dists": h(st.beam_dists), "beam_expl": h(st.beam_expl),
        "pool_ids": h(st.pool_ids), "pool_dists": h(st.pool_dists),
        "stats": h(st.counters.stacked()),
        "home": np.int32(int(st.home)), "qid": np.int32(int(st.qid)),
    }
    if st.lut is not None:
        out["lut"] = h(st.lut)
    if st.lut_scale is not None:
        out["lut_scale"] = h(st.lut_scale)
    return out


def to_device(a, device: torch.device) -> torch.Tensor:
    """A numpy array (or tensor) on ``device``; on a card through pinned
    memory, so the copy does not block the host."""
    if torch.is_tensor(a):
        return a.to(device)
    t = torch.from_numpy(np.array(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def state_from_host(leaves: dict, device) -> QueryState:
    """Host baton -> resident state on ``device`` (inverse of
    :func:`state_to_host`)."""
    device = torch.device(device)
    stats = np.asarray(leaves["stats"], np.int32)
    return QueryState(
        query=to_device(leaves["query"], device),
        beam_ids=to_device(leaves["beam_ids"], device),
        beam_dists=to_device(leaves["beam_dists"], device),
        beam_expl=to_device(leaves["beam_expl"], device),
        pool_ids=to_device(leaves["pool_ids"], device),
        pool_dists=to_device(leaves["pool_dists"], device),
        counters=Counters(*to_device(stats, device).unbind()),
        active=_scalar(True, torch.bool, device),
        done=_scalar(False, torch.bool, device),
        home=_scalar(int(leaves["home"]), I32, device),
        qid=_scalar(int(leaves["qid"]), I32, device),
        lut=to_device(leaves["lut"], device) if "lut" in leaves else None,
    )


def pack_for_wire(st: QueryState, cfg) -> dict:
    """Sender-side hand-off transform: ``baton.pack_sends`` for one state.

    Counts the inter-partition hop on the state, then shapes the wire tree
    per the §8 mode: recompute drops the LUT leaf; f16/i8 ship a quantized
    LUT (the receiver widens/dequantizes, as the engine does).
    """
    leaves = state_to_host(st)
    leaves["stats"] = leaves["stats"].copy()
    leaves["stats"][INTER_HOPS_COL] += 1
    if not cfg.ship_lut:
        leaves.pop("lut", None)
    elif cfg.lut_wire_dtype == "f16":
        leaves["lut"] = leaves["lut"].astype(np.float16)
    elif cfg.lut_wire_dtype == "i8":
        q8, scale = pq.quantize_lut_i8(torch.from_numpy(leaves["lut"]))
        leaves["lut"] = q8.numpy()
        leaves["lut_scale"] = scale.numpy()
    return leaves


def unpack_from_wire(leaves: dict, codebook: torch.Tensor, cfg) -> QueryState:
    """Receiver-side transform: ``baton.merge_recv`` for one state, landing
    on the codebook's device.  Recompute mode rebuilds the LUT from the
    shipped embedding (``cfg.lut_impl``) and counts the build; quantized
    wire LUTs are restored to float32."""
    dev = codebook.device
    leaves = dict(leaves)
    if not cfg.ship_lut:
        leaves["stats"] = np.asarray(leaves["stats"], np.int32).copy()
        leaves["stats"][LUT_BUILDS_COL] += 1
        leaves["query"] = to_device(leaves["query"], dev)
        leaves["lut"] = rebuild_lut(codebook, leaves["query"], cfg.lut_impl)
    elif leaves["lut"].dtype == np.int8:
        leaves["lut"] = pq.dequantize_lut_i8(
            torch.from_numpy(leaves["lut"]),
            torch.from_numpy(leaves.pop("lut_scale")))
    elif leaves["lut"].dtype != np.float32:
        leaves["lut"] = leaves["lut"].astype(np.float32)
    return state_from_host(leaves, dev)
