"""The benchmark's inputs: vectors and query calls, made from ``--seed``.

``make_vectors`` is a frozen copy of the port's synthetic generator
(``repro_torch/data/synth.py``, ``make_dataset``): a clustered Gaussian
mixture drawn with numpy in the same order, in float32.  It is copied,
not imported, so that a change to the program's generator cannot change
what the benchmark measures.  The cluster of every
point is kept, so that a traffic mix can draw its queries by cluster.

A configuration fixes its dataset (``data_seed``) and the seeds of its
index build, as a deployment serves one dataset from one built index; a
run's ``--seed`` draws its queries.  The index decides how many
super-steps the slowest query of a call needs, so a dataset or a build
drawn from each run's seed made the work, and the rate, differ from seed
to seed by a fifth (PERF.md).

``QueryStream`` is the one generator of traffic: a mix is a data file of
parameters (``bench/traffic/<name>.json``) read into it.  Call ``c`` of a
run draws its queries from the generator seeded by ``(seed, stream, c)``,
so the same seed gives the same calls in the same order, whatever the
number of calls a window reaches.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# seed-sequence words that keep the query streams apart
_QUERIES, _ZIPF_RANKING = 1, 2


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """One dataset family: a config file's ``data_spec`` block."""

    name: str
    dim: int
    n_clusters: int = 64
    cluster_std: float = 0.35
    center_scale: float = 0.7


@dataclasses.dataclass
class Vectors:
    spec: DataSpec
    vectors: np.ndarray      # (N, d) float32
    assign: np.ndarray       # (N,) cluster of each point


def make_vectors(spec: DataSpec, n: int, seed: int) -> Vectors:
    """The generator's dataset of ``seed``: centres, assignment and noise,
    drawn in its order from ``default_rng(seed)``, so the port's
    ``make_dataset(spec, n, seed=seed)`` gives the same vectors."""
    rng = np.random.default_rng(seed)
    centers = spec.center_scale * rng.normal(
        size=(spec.n_clusters, spec.dim)).astype(np.float32)
    assign = rng.integers(0, spec.n_clusters, size=n)
    x = centers[assign] + spec.cluster_std * rng.normal(
        size=(n, spec.dim)).astype(np.float32)
    return Vectors(spec=spec, vectors=x, assign=assign.astype(np.int32))


def zipf_shares(n_items: int, exponent: float) -> np.ndarray:
    """Popularity of rank r (1-based): r^-exponent, normalised."""
    w = np.arange(1, n_items + 1, dtype=np.float64) ** -float(exponent)
    return w / w.sum()


@dataclasses.dataclass(frozen=True)
class Traffic:
    """A traffic mix: a ``bench/traffic/<name>.json`` file.

    ``call_queries`` queries a call, one client, calls back to back
    (closed loop).  ``base`` picks the dataset point each query perturbs:
    ``uniform`` over all points, or ``zipf`` over the clusters (the
    clusters ranked by a permutation drawn from ``ranking_seed``, rank r
    drawn with weight r^-``zipf_exponent``), then uniform within the
    cluster.  The perturbation is ``perturb`` times the spec's cluster
    spread."""

    name: str
    call_queries: int
    base: str = "uniform"
    zipf_exponent: float = 0.0
    ranking_seed: int = 0
    perturb: float = 0.5

    def __post_init__(self):
        if self.call_queries < 1:
            raise ValueError(f"call_queries must be >= 1: {self.call_queries}")
        if self.base not in ("uniform", "zipf"):
            raise ValueError(f"base must be uniform|zipf: {self.base!r}")
        if self.base == "zipf" and self.zipf_exponent <= 0:
            raise ValueError("a zipf mix needs zipf_exponent > 0")


class QueryStream:
    """The query calls of one run."""

    def __init__(self, data: Vectors, traffic: Traffic, seed: int):
        self.data = data
        self.traffic = traffic
        self.seed = int(seed)
        self.scale = traffic.perturb * data.spec.cluster_std
        if traffic.base == "zipf":
            k = data.spec.n_clusters
            ranking = np.random.default_rng(
                [traffic.ranking_seed, _ZIPF_RANKING]).permutation(k)
            self.cluster_p = np.empty(k)
            self.cluster_p[ranking] = zipf_shares(k, traffic.zipf_exponent)
            order = np.argsort(data.assign, kind="stable")
            counts = np.bincount(data.assign, minlength=k)
            self.members = np.split(order, np.cumsum(counts)[:-1])
            if min(counts) == 0:
                raise ValueError("a cluster holds no point: n is too small "
                                 "for a zipf mix over the clusters")

    def base_ids(self, rng: np.random.Generator) -> np.ndarray:
        b, n = self.traffic.call_queries, self.data.vectors.shape[0]
        if self.traffic.base == "uniform":
            return rng.integers(0, n, size=b)
        cl = rng.choice(len(self.cluster_p), size=b, p=self.cluster_p)
        out = np.empty(b, np.int64)
        for c in np.unique(cl):
            sel = np.flatnonzero(cl == c)
            out[sel] = self.members[c][rng.integers(0, len(self.members[c]),
                                                    size=len(sel))]
        return out

    def call(self, c: int) -> np.ndarray:
        """The (call_queries, d) float32 queries of call ``c`` (``c = -1``
        is set-up's warm-up call)."""
        rng = np.random.default_rng([self.seed, _QUERIES, c + 1])
        qi = self.base_ids(rng)
        noise = rng.standard_normal(
            (len(qi), self.data.vectors.shape[1]), dtype=np.float32)
        return self.data.vectors[qi] + np.float32(self.scale) * noise
