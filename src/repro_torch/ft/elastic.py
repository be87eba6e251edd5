"""Fault tolerance & elasticity for the serving tier (designed for 1000+
nodes; exercised at small scale in tests).

A copy of ``repro/ft/elastic.py`` (numpy host code; this package imports
nothing of the reference).  Mechanisms:

* **Replicated partition map** — every partition is owned by R devices
  (primary + replicas).  The routing key ``node2part`` maps to a *logical*
  partition; ``PartitionMap`` resolves logical -> physical device, skipping
  devices marked failed.  Because PQ codes/head index are replicated anyway,
  a replica can serve reads for its partition immediately on failover.
* **Query re-issue** — the client tracks undelivered qids per send
  batch and re-issues them (search is deterministic & idempotent, so
  at-least-once delivery is safe).
* **Straggler mitigation** — per-super-step occupancy stats + hedged
  re-issue of queries stuck > T super-steps; the credit-based all_to_all
  already bounds per-step skew (a hot device can only absorb pair_cap
  states per peer per step).
* **Elastic rescale** — rebuild the partition maps for a new device count
  from the persisted assignment (cheap: LDG re-streams from the previous
  assignment as warm start).
* **Elastic placement** — for the cluster simulator's elasticity scenario,
  :func:`rescale_placement` produces the *minimal-move* target
  ``Placement`` for an N→N±k server change (only forced + rebalancing
  copies move; everything else stays home), and :func:`elastic_schedule`
  chains such rescales into a ``cluster.PlacementSchedule`` the simulator
  replays with per-move migration costs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import partition as part_mod


@dataclasses.dataclass
class PartitionMap:
    """logical partition -> physical replica devices.

    Liveness resolves through :class:`ft.faults.FailoverRouter` — the
    same semantic the cluster simulator's fault path routes around crashes
    with — so a device marked failed disappears from every routing surface
    at once.  The router shares this map's ``failed`` set by reference:
    ``fail_device``/``recover_device`` mutate one set, both layers see it.
    """

    n_logical: int
    replicas: np.ndarray          # (P, R) device ids
    failed: set

    def __post_init__(self):
        from repro_torch.ft.faults import FailoverRouter
        self._router = FailoverRouter(
            replicas=tuple(tuple(int(d) for d in r) for r in self.replicas),
            failed=self.failed)

    @classmethod
    def create(cls, n_logical: int, n_devices: int, r: int = 2, seed: int = 0):
        reps = np.zeros((n_logical, r), np.int32)
        for p in range(n_logical):
            # primary placement round-robin; replicas offset to distinct hosts
            prim = p % n_devices
            others = [(prim + 1 + i * (n_devices // r + 1)) % n_devices
                      for i in range(r - 1)]
            reps[p] = [prim] + others
        return cls(n_logical=n_logical, replicas=reps, failed=set())

    def fail_device(self, dev: int):
        self.failed.add(int(dev))

    def recover_device(self, dev: int):
        self.failed.discard(int(dev))

    def owner(self, p: int) -> int:
        """Current serving device for logical partition p."""
        return self._router.owner(p)

    def routing_table(self) -> np.ndarray:
        """(P,) logical -> physical map for the current failure set."""
        return np.array([self.owner(p) for p in range(self.n_logical)],
                        np.int32)

    def coverage_ok(self) -> bool:
        return self._router.coverage_ok()


@dataclasses.dataclass
class ReissueTracker:
    """Client-side at-least-once delivery: re-issue undelivered queries."""

    max_attempts: int = 3

    def missing(self, expected_qids, delivered_mask) -> np.ndarray:
        expected_qids = np.asarray(expected_qids)
        return expected_qids[~np.asarray(delivered_mask, bool)]

    def run_with_retries(self, run_fn, queries: np.ndarray):
        """run_fn(queries) -> (ids, dists, stats w/ per-query 'hops').

        Per-query ndarray stats **sum** across attempts (a retried query
        pays for every attempt's hops — honest pricing); scalar stats sum
        too (run totals).  ``agg_stats["exhausted"]`` counts the queries
        still undelivered after ``max_attempts`` — the same queries in the
        returned ``pending``, whose rows stay at the ``-1``/``inf``
        sentinels."""
        n = queries.shape[0]
        ids = None
        dists = None
        pending = np.arange(n)
        attempts = 0
        agg_stats: "dict | None" = None
        while len(pending) and attempts < self.max_attempts:
            r_ids, r_dists, r_stats = run_fn(queries[pending])
            if ids is None:
                ids = np.full((n, r_ids.shape[1]), -1, r_ids.dtype)
                dists = np.full((n, r_dists.shape[1]), np.inf, r_dists.dtype)
                agg_stats = {
                    k: (np.zeros(n, dtype=np.asarray(v).dtype)
                        if isinstance(v, np.ndarray) else type(v)(0))
                    for k, v in r_stats.items()}
            ok = r_ids[:, 0] >= 0
            ids[pending[ok]] = r_ids[ok]
            dists[pending[ok]] = r_dists[ok]
            for k, v in r_stats.items():
                if isinstance(v, np.ndarray):
                    # every attempt is charged, delivered or not — a query
                    # served on attempt 2 cost attempt 1's hops too
                    agg_stats[k][pending] += v
                else:
                    agg_stats[k] += v
            pending = pending[~ok]
            attempts += 1
        if agg_stats is not None:
            agg_stats["exhausted"] = int(len(pending))
        return ids, dists, agg_stats, pending


def rescale_placement(placement, n_servers: int):
    """Minimal-move target :class:`cluster.Placement` for N→N±k servers.

    Args:
        placement: the current ``cluster.Placement`` (partition → replica
            server tuple; first entry is the primary).
        n_servers: the new server count.  Servers ``>= n_servers`` are
            being decommissioned; new ids below it are empty and absorb
            moved copies.

    Returns:
        A ``Placement`` over the same partitions whose per-server copy
        counts are balanced to within one copy of the mean, reached with
        the minimum number of copy moves: copies on decommissioned servers
        *must* move (forced), and beyond that only the excess over each
        server's balanced target moves.  Untouched partitions keep their
        exact replica tuples, so the simulator re-homes (and charges
        migration for) moved partitions only.  Deterministic: donors are
        drained most-loaded-first, receivers filled emptiest-first, ties
        break toward the lower server / partition index.
    """
    from repro_torch.cluster.stages import Placement

    if n_servers < 1:
        raise ValueError(f"n_servers must be >= 1: {n_servers}")
    reps = [list(r) for r in placement.replicas]
    total = sum(len(r) for r in reps)
    cnt = [0] * n_servers
    for r in reps:
        for s in r:
            if s < n_servers:
                cnt[s] += 1
    # balanced per-server targets: ceil for the currently-fullest servers
    # (minimizes moves), floor for the rest
    base, extra = divmod(total, n_servers)
    target = [base] * n_servers
    for s in sorted(range(n_servers), key=lambda x: (-cnt[x], x))[:extra]:
        target[s] += 1

    def receiver(exclude) -> int:
        """Emptiest server below target not already holding the partition."""
        cands = [s for s in range(n_servers)
                 if cnt[s] < target[s] and s not in exclude]
        if not cands:  # replica constraint blocks all deficit servers
            cands = [s for s in range(n_servers) if s not in exclude]
        return min(cands, key=lambda s: (cnt[s] - target[s], s))

    # 1) forced moves: copies on decommissioned servers
    for r in reps:
        for i, s in enumerate(r):
            if s >= n_servers:
                d = receiver(set(r) - {s})
                r[i] = d
                cnt[d] += 1
    # 2) rebalance: drain servers above target into servers below it
    while True:
        donors = [s for s in range(n_servers) if cnt[s] > target[s]]
        if not donors:
            break
        s = min(donors, key=lambda x: (-(cnt[x] - target[x]), x))
        for p, r in enumerate(reps):  # lowest partition index on the donor
            if s in r:
                cands = [d for d in range(n_servers)
                         if cnt[d] < target[d] and d not in r]
                if cands:
                    d = min(cands, key=lambda x: (cnt[x] - target[x], x))
                    r[r.index(s)] = d
                    cnt[s] -= 1
                    cnt[d] += 1
                    break
        else:  # replica constraints block every move off this donor
            break
    return Placement(tuple(tuple(r) for r in reps))


def elastic_schedule(steps, n_parts: int):
    """Chain minimal-move rescales into a ``cluster.PlacementSchedule``.

    Args:
        steps: ``[(t0_s, n0), (t1_s, n1), ...]`` — at simulation time
            ``tk_s`` (seconds) the serving tier scales to ``nk`` servers.
            ``t0_s`` must be 0.0 (every instant needs a placement).
        n_parts: size of the fixed partition set being re-homed.

    Returns:
        A ``PlacementSchedule`` whose first epoch is the modular fold of
        ``n_parts`` partitions onto ``n0`` servers and whose every later
        epoch is :func:`rescale_placement` of its predecessor — so each
        boundary moves (and the simulator charges migration for) the
        minimal set of partition copies.
    """
    from repro_torch.cluster.stages import Placement, PlacementSchedule

    if not steps:
        raise ValueError("elastic schedule needs at least one (t, n) step")
    epochs = []
    pl = Placement.fold(n_parts, int(steps[0][1]))
    epochs.append((float(steps[0][0]), pl))
    for t, n in steps[1:]:
        pl = rescale_placement(pl, int(n))
        epochs.append((float(t), pl))
    return PlacementSchedule(tuple(epochs))


def rescale_assignment(neighbors: np.ndarray, old_assign: np.ndarray,
                       new_p: int, seed: int = 0) -> np.ndarray:
    """Elastic rescale: re-partition for a new device count, warm-started
    from the previous assignment (modular fold keeps most locality)."""
    warm = old_assign % new_p
    n = len(old_assign)
    cap = part_mod.partition_capacity(n, new_p)
    sizes = np.bincount(warm, minlength=new_p).astype(np.int64)
    rng = np.random.default_rng(seed)
    assign = warm.copy().astype(np.int32)
    # one LDG refinement pass under the new capacity
    for v in rng.permutation(n):
        nbrs = neighbors[v]
        nbrs = nbrs[nbrs >= 0]
        if len(nbrs) == 0:
            continue
        counts = np.bincount(assign[nbrs], minlength=new_p).astype(np.float64)
        old = assign[v]
        sizes[old] -= 1
        score = counts * (1.0 - sizes / cap)
        score[sizes >= cap] = -np.inf
        new = int(np.argmax(score))
        assign[v] = new
        sizes[new] += 1
    return assign
