"""Disk / network cost model calibrated to the paper's testbed (§6 Setup).

Counterpart of ``repro/io_sim/disk.py``: the same constants and the same
arithmetic, copied (this package imports nothing of the reference).  The
engines' throughput and latency figures are *derived* from exactly-counted
events (sector reads, distance comparisons, inter-partition hops, envelope
bytes) through this model; they model the paper's CPU/SSD cluster, not the
card the port runs on.

Calibration targets (c6620: 28-core Xeon Gold 5512U @2.1 GHz, NVMe SSD,
25 Gb Ethernet; paper + DiskANN/PipeANN measurements):

* SSD random 4 KB read: ~100 us latency, >=300 K IOPS sustained  [18, 13]
* W parallel reads cost ~= one read (I/O pipeline, §4.4)
* PQ distance comparison: ~0.05 us each amortized (SIMD ADC, 32-byte codes)
* TCP one-way small-message latency: ~30 us; 25 Gb/s line rate
* serialization/deserialization of a state envelope: ~2 us [§5]

These constants are configurable so sensitivity is testable.

§8 "Reducing Message Size" — ship vs recompute the PQ LUT
---------------------------------------------------------
The baton envelope optionally carries the query's PQ lookup table
(``BatonParams.ship_lut``).  Shipping adds M·K·4 bytes to every hand-off
(e.g. 24 KB for M=24, K=256 — dwarfing the ~4 KB base envelope) but the
receiver resumes scoring immediately; recomputing keeps the wire at the
paper's 4-8 KB at the cost of one LUT build (M·K·dsub MACs, ~microseconds)
per arrival, counted in ``Counters.lut_builds``.  Both sides of the
tradeoff are measurable here: feed ``state.envelope_bytes(d, L, P, m, k_pq,
ship_lut=...)`` into ``query_latency_s`` / ``cluster_qps`` (the
``sec8_ship_vs_recompute`` benchmark does exactly this).  At 25 GbE the
wire-time delta is ~7.7 us per hand-off for the 24 KB LUT — comparable to
the LUT rebuild cost, which is why the paper calls this knob out as
deployment-dependent rather than always-on.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CostModel:
    ssd_read_latency_us: float = 100.0
    ssd_iops: float = 300_000.0          # per server
    dist_comp_us: float = 0.05           # PQ ADC per comparison (SIMD)
    full_dist_comp_us: float = 0.10      # full-precision (128-d float)
    tcp_one_way_us: float = 30.0         # small-message one-way latency
    tcp_bandwidth_gbps: float = 25.0
    serialize_us: float = 2.0            # per envelope (object pooling, §5)
    lut_build_us: float = 5.0            # PQ LUT rebuild on arrival (M·K·dsub
    #                                      MACs, SIMD) — the recompute side of
    #                                      the §8 ship-vs-recompute tradeoff
    threads_per_server: int = 8          # paper runs 8 search threads
    states_per_thread: int = 8           # fixed-count inter-query balancing
    cache_hit_service_us: float = 1.0    # DRAM sector-cache hit (no SSD
    #                                      queue) — the memory-hierarchy tier
    #                                      SPANN keeps its centroid level in
    sector_bytes: int = 4096             # one cached/read sector (4 KB)

    # ---- event-simulator service-time primitives (repro.cluster) ----------
    # The discrete-event cluster simulator replays per-query traces through
    # queues whose *service times* come from exactly these constants, so the
    # closed-form `query_latency_s` below is its zero-load limit (tested to
    # <1%: tests/test_cluster_sim.py::test_zero_load_matches_closed_form).

    @property
    def read_service_s(self) -> float:
        """Service time of one (pipelined batch of) 4 KB sector read(s)."""
        return self.ssd_read_latency_us * 1e-6

    @property
    def ssd_channels(self) -> int:
        """Concurrent in-flight reads that sustain ``ssd_iops`` at
        ``ssd_read_latency_us`` (Little's law: c = IOPS × latency)."""
        return max(1, int(round(self.ssd_iops * self.read_service_s)))

    @property
    def cache_hit_service_s(self) -> float:
        """Service time of a sector-cache hit (DRAM; bypasses the SSD
        channel queue — the cluster simulator's cache tier charges this)."""
        return self.cache_hit_service_us * 1e-6

    @property
    def server_slots(self) -> int:
        """Resident query states per server (fixed-count balancing, §5)."""
        return self.threads_per_server * self.states_per_thread

    def cache_memory_bytes(self, cache_sectors: int) -> int:
        """DRAM held by a per-server sector cache of ``cache_sectors``."""
        return cache_sectors * self.sector_bytes

    def replica_memory_bytes(self, partition_bytes: float,
                             copies_per_partition: float) -> float:
        """Extra per-partition storage bought by replication.

        ``copies_per_partition`` is ``Placement.copies_per_partition``; the
        first copy is the baseline deployment, so only the additional
        copies are priced.  Together with :meth:`cache_memory_bytes` this
        keeps the DRAM side of the cache/replication scenarios priced
        symmetrically with their wire/latency side (the §8 pattern)."""
        return max(copies_per_partition - 1.0, 0.0) * partition_bytes

    def compute_s(self, dist_comps: float, lut_builds: float = 0.0) -> float:
        """CPU service time of one hop's scoring work."""
        return (dist_comps * self.dist_comp_us
                + lut_builds * self.lut_build_us) * 1e-6

    def tx_s(self, n_bytes: float) -> float:
        """Sender-side NIC occupancy: serialization + wire time."""
        return (self.serialize_us
                + n_bytes * 8.0 / (self.tcp_bandwidth_gbps * 1e3)) * 1e-6

    @property
    def rx_s(self) -> float:
        """Receiver-side deserialization (flat, uncontended)."""
        return self.serialize_us * 1e-6

    @property
    def propagation_s(self) -> float:
        """One-way small-message network latency."""
        return self.tcp_one_way_us * 1e-6

    # ---- per-query latency (seconds) --------------------------------------
    def query_latency_s(
        self,
        hops: float,
        inter_hops: float,
        reads: float,
        dist_comps: float,
        envelope_bytes: int,
        lut_builds: float = 0.0,
        cache_hit_hops: float = 0.0,
    ) -> float:
        """End-to-end latency of one query (no queueing).

        Each beam-search step waits one SSD read round (W reads issued in
        parallel cost ~1 latency, §4.4); each inter-partition hop adds one
        one-way TCP latency + serialization + wire time (the *baton* pattern:
        one-way, not round trip — the paper's core claim).  ``lut_builds``
        charges the recompute side of §8: pass the per-query LUT-build count
        so ship (bigger envelope, lut_builds~1) and recompute (small
        envelope, 1+inter_hops builds) are priced symmetrically.
        ``cache_hit_hops`` counts read rounds served entirely from the DRAM
        sector cache — they cost ``cache_hit_service_us`` instead of an SSD
        round (the memory-hierarchy tier, priced symmetrically with the
        DRAM it occupies via :meth:`cache_memory_bytes`).
        """
        cache_hit_hops = min(cache_hit_hops, hops)
        io = ((hops - cache_hit_hops) * self.ssd_read_latency_us
              + cache_hit_hops * self.cache_hit_service_us)
        net = inter_hops * (
            self.tcp_one_way_us
            + 2 * self.serialize_us
            + envelope_bytes * 8.0 / (self.tcp_bandwidth_gbps * 1e3)  # us
        )
        cpu = dist_comps * self.dist_comp_us + lut_builds * self.lut_build_us
        return (io + net + cpu) * 1e-6

    def query_latency_rr_s(self, hops, round_trips, reads, dist_comps,
                           reply_bytes: int = 512) -> float:
        """Request-reply variant (DistributedANN-style) for comparison:
        every remote access is a full round trip."""
        io = hops * self.ssd_read_latency_us
        net = round_trips * (
            2 * self.tcp_one_way_us + 2 * self.serialize_us
            + reply_bytes * 8.0 / (self.tcp_bandwidth_gbps * 1e3)
        )
        cpu = dist_comps * self.dist_comp_us
        return (io + net + cpu) * 1e-6

    # ---- cluster throughput (QPS) -----------------------------------------
    def cluster_qps(
        self,
        n_servers: int,
        reads_per_query: float,
        dist_comps_per_query: float,
        inter_hops_per_query: float = 0.0,
        envelope_bytes: int = 4096,
        lut_builds_per_query: float = 0.0,
    ) -> float:
        """Sustained QPS of the cluster = min over resource bottlenecks.

        Disk: total IOPS across servers / reads-per-query.
        CPU:  total thread-time / compute-per-query (incl. §8 LUT rebuilds).
        NET:  total NIC bandwidth / state-transfer bytes per query.
        (The paper identifies disk I/O and distance comps as the two
        dominant bottlenecks, §4.4; network enters through inter-hops.)
        """
        disk_qps = n_servers * self.ssd_iops / max(reads_per_query, 1e-9)
        cpu_us = dist_comps_per_query * self.dist_comp_us + \
            inter_hops_per_query * 2 * self.serialize_us + \
            lut_builds_per_query * self.lut_build_us
        cpu_qps = n_servers * self.threads_per_server * 1e6 / max(cpu_us, 1e-9)
        if inter_hops_per_query > 0:
            wire_bits = inter_hops_per_query * envelope_bytes * 8.0
            net_qps = n_servers * self.tcp_bandwidth_gbps * 1e9 / wire_bits
        else:
            net_qps = float("inf")
        return min(disk_qps, cpu_qps, net_qps)

    def bottleneck(self, n_servers, reads_per_query, dist_comps_per_query,
                   inter_hops_per_query=0.0, envelope_bytes=4096) -> str:
        vals = {
            "disk": n_servers * self.ssd_iops / max(reads_per_query, 1e-9),
            "cpu": n_servers * self.threads_per_server * 1e6
            / max(dist_comps_per_query * self.dist_comp_us, 1e-9),
        }
        if inter_hops_per_query > 0:
            vals["net"] = (
                n_servers * self.tcp_bandwidth_gbps * 1e9
                / (inter_hops_per_query * envelope_bytes * 8.0)
            )
        return min(vals, key=vals.get)


DEFAULT = CostModel()
