"""Partition-owning workers: the service loop behind the executable tier.

Counterpart of ``repro/serve_async/worker.py`` in thread mode.  A worker
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
"""

from __future__ import annotations

import threading
import time

from repro_torch.device import SyncMeter
from repro_torch.serve_async import runtime, wire

# message kinds on the result queue
RESULT = "result"
# hand-off payload tags (first element of a hand-off queue item)
FRAME = "frame"      # coalesced cross-worker frame: (FRAME, bytes)
LOCAL = "local"      # same-worker short-circuit: (LOCAL, arrival, part, leaves)


def _expand(got, codebook, cfg):
    """Drained queue items -> work list of ``(arrival_id, state, part)``."""
    work = []
    for kind, msg in got:
        if kind == "admit":
            arrival_id, qid, home, query, starts, start_d, lut = msg
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
