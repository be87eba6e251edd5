"""Open-loop arrival generators (a copy of ``repro/cluster/workload.py``).

The port keeps its own copy (numpy only) so that the executable tier's
open-loop client replays the same schedules as the reference's for the same
seed.  All generators are seeded and produce a fixed-length :class:`Workload`
(arrival times + which trace each arrival replays), so a simulation run is a
pure function of (traces, workload, params) — the determinism the replay
tests rely on.

Four processes (paper §6 drives load open-loop at a fixed send rate; the
burst/skew/diurnal variants are the obvious stress scenarios the
closed-form model cannot price):

* ``poisson`` — memoryless arrivals at ``rate_qps``; traces drawn uniformly.
* ``burst``   — compound-Poisson clusters: bursts of ``burst_size`` queries
                arrive back-to-back, burst *starts* are Poisson at
                ``rate_qps / burst_size`` (same mean rate, bursty variance).
* ``skew``    — Poisson arrivals, but traces are drawn with a Zipf-weighted
                preference over *home servers*, concentrating load on a few
                servers (hot-tenant scenario).
* ``diurnal`` — day-in-the-life: a sinusoidal rate envelope around the mean
                rate realized by Poisson thinning (:func:`diurnal`), shared
                by the simulator and the executable serving tier.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Workload:
    times_s: np.ndarray    # (n,) sorted arrival times, seconds
    trace_idx: np.ndarray  # (n,) index into the trace list
    rate_qps: float
    kind: str

    @property
    def n(self) -> int:
        return len(self.times_s)


def make_workload(
    n_traces: int,
    rate_qps: float,
    n: int,
    arrival: str = "poisson",
    seed: int = 0,
    burst_size: int = 8,
    skew_alpha: float = 1.5,
    homes: "np.ndarray | None" = None,
) -> Workload:
    """Generate ``n`` arrivals at mean rate ``rate_qps``.

    ``homes`` (one home-server id per trace) is required for ``skew``.
    """
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be > 0: {rate_qps}")
    rng = np.random.default_rng(seed)

    if arrival == "poisson":
        times = np.cumsum(rng.exponential(1.0 / rate_qps, size=n))
        idx = rng.integers(0, n_traces, size=n)
    elif arrival == "burst":
        n_bursts = max(1, (n + burst_size - 1) // burst_size)
        starts = np.cumsum(
            rng.exponential(burst_size / rate_qps, size=n_bursts)
        )
        times = (starts[:, None] + 1e-6 * np.arange(burst_size)).reshape(-1)[:n]
        idx = rng.integers(0, n_traces, size=len(times))
    elif arrival == "skew":
        if homes is None:
            raise ValueError("skew arrivals need `homes` (per-trace server)")
        homes = np.asarray(homes)
        if len(homes) != n_traces:
            raise ValueError(f"homes has {len(homes)} entries, not "
                             f"n_traces={n_traces}")
        times = np.cumsum(rng.exponential(1.0 / rate_qps, size=n))
        servers = np.unique(homes)
        w = 1.0 / np.arange(1, len(servers) + 1) ** skew_alpha  # Zipf weights
        w /= w.sum()
        by_home = [np.flatnonzero(homes == s) for s in servers]
        pick_srv = rng.choice(len(servers), size=n, p=w)
        idx = np.array([
            by_home[s][rng.integers(0, len(by_home[s]))] for s in pick_srv
        ])
    elif arrival == "diurnal":
        return diurnal(n_traces, rate_qps, n, seed=seed)
    else:
        raise ValueError(
            f"arrival must be poisson|burst|skew|diurnal: {arrival}")

    return Workload(times_s=times, trace_idx=idx, rate_qps=rate_qps,
                    kind=arrival)


def diurnal(
    n_traces: int,
    rate_qps: float,
    n: int,
    seed: int = 0,
    day_s: "float | None" = None,
    peak_ratio: float = 3.0,
) -> Workload:
    """Day-in-the-life arrivals: sinusoidal rate envelope × Poisson thinning.

    The instantaneous rate swings around the mean ``rate_qps`` with a
    peak/trough ratio of ``peak_ratio`` over one period of ``day_s``
    seconds (default: one "day" spans the expected run, ``n / rate_qps``),
    starting at the trough.  Realized by thinning a homogeneous Poisson
    process at the peak rate — the standard exact construction — so the
    mean rate is ``rate_qps`` and the envelope shape is honoured pointwise.

    With the default ``day_s`` the accepted pattern is *rate-invariant*
    given a seed: changing ``rate_qps`` rescales every arrival time by the
    rate ratio but keeps the same arrival sequence — so the simulator and
    the executable tier can run "the same schedule" at each system's own
    operating rate.
    """
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be > 0: {rate_qps}")
    if peak_ratio < 1.0:
        raise ValueError(f"peak_ratio must be >= 1: {peak_ratio}")
    if day_s is None:
        day_s = n / rate_qps
    rng = np.random.default_rng(seed)
    amp = (peak_ratio - 1.0) / (peak_ratio + 1.0)   # envelope in [1-amp, 1+amp]
    peak = rate_qps * (1.0 + amp)
    times = np.empty(0, dtype=np.float64)
    t0 = 0.0
    while len(times) < n:
        m = int((n - len(times)) * (1.0 + amp) * 1.2) + 64
        cand = t0 + np.cumsum(rng.exponential(1.0 / peak, size=m))
        env = 1.0 + amp * np.sin(2.0 * np.pi * cand / day_s - np.pi / 2.0)
        keep = rng.random(m) < env / (1.0 + amp)
        times = np.concatenate([times, cand[keep]])
        t0 = float(cand[-1])
    times = times[:n]
    idx = rng.integers(0, n_traces, size=n)
    return Workload(times_s=times, trace_idx=idx, rate_qps=rate_qps,
                    kind="diurnal")
