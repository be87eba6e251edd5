"""The executable tier's service-layer entry point.

Counterpart of ``repro/api/deployment.py``'s ``EXEC_FIELDS`` and
``Deployment.run_exec``; the rest of ``Deployment`` (cost model, simulator,
reports) waits for ROADMAP queue 1 item 5, so ``run_exec`` is a function of
the engine and the config sections it reads.
"""

from __future__ import annotations

import numpy as np

from repro_torch.cluster import make_workload
from repro_torch.serve_async import AsyncServingTier

# run_exec()'s key schema, the reference's (same order)
EXEC_FIELDS = (
    "workers", "mode", "rate_qps", "arrival", "offered", "completed",
    "rejected", "handoffs", "mean_s", "p50_s", "p95_s", "p99_s",
    "throughput_qps", "makespan_s", "wire_bytes_per_handoff",
    "envelope_bytes", "parity", "batch", "advance_calls", "local_handoffs",
    "wire_frames", "wire_batons", "wire_bytes",
)


def run_exec(engine, exec_spec, search_params, queries) -> dict:
    """Run the ``exec`` section on real workers over ``engine``'s index.

    An ``AsyncServingTier`` with ``exec_spec.workers`` partition-owning
    workers serves the query batch, closed-loop (``send_rate == 0``: every
    query completes) or open-loop from the configured arrival schedule
    (bounded admission rejects under overload).

    Returns the ``EXEC_FIELDS`` dict: measured wall-clock latency
    percentiles, throughput and hand-off accounting, plus ``parity``:
    whether every completed arrival's (ids, dists) equal
    ``engine.search``'s bit for bit on the replayed query.

    Raises ``ValueError`` if ``exec_spec.workers == 0`` (tier disabled) or
    the engine is not the baton engine.
    """
    ex = exec_spec
    if ex.workers < 1:
        raise ValueError(
            "exec tier disabled (exec.workers == 0); set exec.workers "
            ">= 1 (serve launcher: --exec-workers)")
    if engine.name != "baton":
        raise ValueError(f"exec tier requires the baton engine: {engine.name}")
    queries = np.asarray(queries, np.float32)
    expect = engine.search(queries, search_params)      # the parity yardstick
    tier = AsyncServingTier(
        engine.index, engine.baton_params(search_params),
        n_workers=ex.workers, mode=ex.mode, slots=ex.slots or None,
        admit_headroom=ex.admit_headroom, queue_cap=ex.queue_cap,
        batch=ex.batch)
    try:
        if ex.send_rate > 0:
            wl = make_workload(len(queries), ex.send_rate, ex.n_arrivals,
                               ex.arrival, seed=ex.seed)
            res = tier.serve(queries, wl, time_scale=ex.time_scale)
        else:
            res = tier.search(queries)
    finally:
        tier.close()
    ok = res.accepted
    parity = bool(
        np.array_equal(res.ids[ok], expect.ids[res.trace_idx[ok]])
        and np.array_equal(res.dists[ok], expect.dists[res.trace_idx[ok]]))
    return {
        "workers": ex.workers, "mode": ex.mode,
        "rate_qps": res.rate_qps, "arrival": ex.arrival,
        "offered": res.offered, "completed": res.completed,
        "rejected": res.rejected, "handoffs": res.handoffs,
        "mean_s": res.mean_s, "p50_s": res.percentile_s(50),
        "p95_s": res.percentile_s(95), "p99_s": res.percentile_s(99),
        "throughput_qps": res.throughput_qps,
        "makespan_s": res.makespan_s,
        "wire_bytes_per_handoff": res.wire_bytes_per_handoff,
        "envelope_bytes": res.envelope_bytes,
        "parity": parity,
        "batch": res.batch,
        "advance_calls": res.advance_calls,
        "local_handoffs": res.local_handoffs,
        "wire_frames": res.wire_frames,
        "wire_batons": res.wire_batons,
        "wire_bytes": res.wire_bytes,
    }
