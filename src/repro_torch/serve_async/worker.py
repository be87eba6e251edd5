"""Partition-owning workers: the service loop behind the executable tier.

Counterpart of ``repro/serve_async/worker.py``.  A worker
owns the partitions ``part % n_workers == wid``.  Its loop is the
executable version of the engine's super-step, a micro-batch of batons at a
time:

    drain up to ``batch`` batons (hand-offs first)  — queues.get_many
      admit: seed the state                         — baton.refill
      frame: decode + LUT restore per baton         — baton.merge_recv
      local: in-memory leaves, no codec             — co-location short cut
    group by resident partition and advance each
    group in ONE call                               — runtime.advance_batch
      (a single baton takes the per-state path,     — baton.local_advance
       so batch=1 reproduces the one-at-a-time loop)
    done  -> result message to client               — baton.deliver_local
    else  -> coalesce all batons bound for the same — baton.pack_sends
             destination worker into one frame

Groups advance in power-of-two chunks, as in the reference (where each
distinct batch shape was one compile): the grouping, and so
``advance_calls``, are part of the tier's result.  The per-query math is
untouched, so where, when and with whom a baton runs never changes what it
computes.  A hand-off to a partition of the same worker still counts an
``inter_hops`` and runs the wire transforms, only the byte codec is
skipped.  After an advance the group's states come back to the host in one
transfer (``runtime.to_host``); each worker counts its host syncs in its
own ``SyncMeter``.

The same loop body serves both modes.  Thread workers share the parent's
shards and kernel libraries.  A process worker (``process_worker_main``,
started from a spawn context) rebuilds its shards and the codebook from
numpy on the device the parent names — the card, where the parent runs on
it — loads the kernel libraries the parent built, warms every advance
variant, and only then reports ready.  Its syncs go to a
``SharedSyncMeter`` the parent reads; when it stops it sends its kernel
launch counts back on the result queue.
"""

from __future__ import annotations

import threading
import time
import traceback

import torch

from repro_torch.device import SyncMeter, resolve_device
from repro_torch.serve_async import runtime, wire

# message kinds on the result queue
RESULT = "result"
READY = "ready"      # a process worker is serving: (READY, wid, stamps)
STOPPED = "stopped"  # a process worker stopped: (STOPPED, wid, launches)
ERROR = "error"      # a process worker raised: (ERROR, wid, traceback)
# hand-off payload tags (first element of a hand-off queue item)
FRAME = "frame"      # coalesced cross-worker frame: (FRAME, bytes)
LOCAL = "local"      # same-worker short-circuit: (LOCAL, arrival, part, leaves)


def _expand(got, codebook, cfg):
    """Drained queue items -> work list of ``(arrival_id, state, part)``."""
    work = []
    for kind, msg in got:
        if kind == "admit":
            # device rows in thread mode, numpy rows in process mode
            arrival_id, qid, home, *rows = msg
            query, starts, start_d, lut = (
                runtime.to_device(x, codebook.device) for x in rows)
            st = runtime.seed_state(query, starts, start_d, lut, home, qid,
                                    cfg.L, cfg.pool)
            work.append((arrival_id, st, int(home)))
        elif msg[0] == LOCAL:
            _, arrival_id, part, leaves = msg
            st = runtime.unpack_from_wire(leaves, codebook, cfg)
            work.append((arrival_id, st, int(part)))
        else:
            for arrival_id, part, payload in wire.decode_frame(msg[1]):
                st = runtime.unpack_from_wire(
                    wire.decode_baton(payload), codebook, cfg)
                work.append((arrival_id, st, int(part)))
    return work


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def service_loop(wid: int, shards: dict, codebook, cfg, inbox, inboxes,
                 part2worker, results, batch: int = 1,
                 meter: "SyncMeter | None" = None) -> None:
    """Drain the inbox until stopped; see the module docstring for the map
    from each step to its engine counterpart."""
    k = cfg.k
    meter = meter or SyncMeter()
    dev = codebook.device
    while True:
        got = inbox.get_many(batch)
        if got is None:
            return
        work = _expand(got, codebook, cfg)
        outgoing = []                       # (arrival_id, dest_part, state)
        while work:
            part = work[0][2]
            group = [it for it in work if it[2] == part]
            work = [it for it in work if it[2] != part]
            # power-of-two chunks of {1, 2, 4, ..., batch}; the rest
            # re-enter the work list and ride the next chunk
            take = _pow2_floor(len(group))
            group, work = group[:take], work + group[take:]
            if len(group) == 1:
                a, st, _ = group[0]
                st, done, dest = runtime.advance_state(
                    st, shards[part], part, cfg.W, cfg.max_local_steps,
                    meter=meter)
                st, done, dest = runtime.to_host((st, done, dest), dev, meter)
                resolved = [(a, st, bool(done), int(dest))]
            else:
                sts = runtime.stack_states([g[1] for g in group])
                sts, done, dest = runtime.advance_batch(
                    sts, shards[part], part, cfg.W, cfg.max_local_steps,
                    adc_impl=cfg.adc_impl, merge_impl=cfg.merge_impl,
                    meter=meter)
                sts, done, dest = runtime.to_host((sts, done, dest), dev,
                                                  meter)
                states = runtime.unstack_states(sts, len(group))
                resolved = [
                    (group[i][0], states[i], bool(done[i]), int(dest[i]))
                    for i in range(len(group))
                ]
            inbox.add_advance()
            for a, st, done, dest in resolved:
                if done:
                    results.put((
                        RESULT, a, int(st.qid),
                        st.pool_ids[:k].numpy().copy(),
                        st.pool_dists[:k].numpy().copy(),
                        st.counters.stacked().numpy().copy(),
                        time.perf_counter(),
                    ))
                    inbox.release()
                elif dest == part:
                    # max_local_steps fired with local work left: the state
                    # stays in this drain's work list — the next super-step
                    work.append((a, runtime.on_device(st, dev), part))
                else:
                    outgoing.append((a, dest, st))
        # --- coalesced hand-offs: one message per destination worker -------
        by_worker: dict = {}
        for a, dest, st in outgoing:
            by_worker.setdefault(part2worker[dest], []).append((a, dest, st))
        for dw, items in sorted(by_worker.items()):
            if dw == wid:
                # co-location short-circuit: wire transforms, no codec
                for a, dest, st in items:
                    inboxes[wid].push_handoff(
                        (LOCAL, a, dest, runtime.pack_for_wire(st, cfg)),
                        n=1, local=True)
            else:
                records = [
                    (a, dest, wire.encode_baton(runtime.pack_for_wire(st,
                                                                      cfg)))
                    for a, dest, st in items
                ]
                frame = wire.encode_frame(records)
                inboxes[dw].push_handoff(
                    (FRAME, frame), n=len(records), nbytes=len(frame))
            for _ in items:
                inbox.release()


def start_thread_worker(wid, shards, codebook, cfg, inbox, inboxes,
                        part2worker, results, batch=1,
                        meter=None) -> threading.Thread:
    t = threading.Thread(
        target=service_loop, name=f"serve-async-w{wid}", daemon=True,
        args=(wid, shards, codebook, cfg, inbox, inboxes, part2worker,
              results, batch, meter),
    )
    t.start()
    return t


class SharedSyncMeter(SyncMeter):
    """A ``SyncMeter`` whose count and seconds live in shared memory: a
    process worker counts into it, the parent reads it (``tier.run`` diffs
    it per run, as it does a thread worker's meter)."""

    def __init__(self, ctx):
        self._count = ctx.Value("q", 0)
        self._seconds = ctx.Value("d", 0.0)
        super().__init__()

    @property
    def count(self) -> int:
        return self._count.value

    @count.setter
    def count(self, v: int) -> None:
        with self._count.get_lock():
            self._count.value = v

    @property
    def seconds(self) -> float:
        return self._seconds.value

    @seconds.setter
    def seconds(self, v: float) -> None:
        with self._seconds.get_lock():
            self._seconds.value = v


def process_worker_main(wid, setup, cfg_dict, device, inbox, inboxes,
                        part2worker, results, batch=1, meter=None) -> None:
    """Child-process entry: rebuild the shards on ``device``, then serve.

    ``setup`` is a queue that delivers ``(shard_arrays, codebook)``:
    each owned partition's numpy leaves of its ``runtime.partition_shard``
    and the codebook as numpy.  ``cfg_dict`` is the ``BatonParams`` field
    dict.  ``device`` is the parent's index device ("cuda:0" on the card):
    asking for a card that is not there raises, nothing falls back to the
    host.  Any failure is reported on ``results`` as ``ERROR`` with its
    traceback before it propagates.
    """
    t_entry = time.time()
    from repro_torch import kernels
    from repro_torch.core.baton import BatonParams
    from repro_torch.core.beam_search import Shard

    try:
        # the children share the host's cores; their host work is small
        # per call, so one intra-op thread each
        torch.set_num_threads(1)
        dev = resolve_device(device)
        cfg = BatonParams(**cfg_dict)
        shard_arrays, codebook_np = setup.get()
        shards = {
            part: Shard(**{name: None if a is None
                           else torch.from_numpy(a).to(dev)
                           for name, a in leaves.items()})
            for part, leaves in shard_arrays.items()}
        codebook = torch.from_numpy(codebook_np).to(dev)
        if dev.type == "cuda":
            # the parent built every library: this only loads them (a
            # missing one is built, or raises where there is no nvcc)
            from repro_torch.kernels import _build

            for name in _build.SOURCES:
                _build.load(name)
            torch.cuda.synchronize(dev)
        t_loaded = time.time()
        pq_m, pq_k = codebook.shape[:2]
        dim = next(iter(shards.values())).vectors.shape[-1]
        runtime.warm(shards, cfg, batch,
                     runtime.dummy_state(dim, cfg, pq_m, pq_k, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        kernels.reset_launch_counts()
        results.put((READY, wid, {"entry": t_entry, "loaded": t_loaded,
                                  "warm": time.time()}))
        service_loop(wid, shards, codebook, cfg, inbox, inboxes, part2worker,
                     results, batch, meter)
        results.put((STOPPED, wid, kernels.launch_counts()))
    except Exception:
        results.put((ERROR, wid, traceback.format_exc()))
        raise
