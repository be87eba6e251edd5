"""core/ref.py of the port against the reference: the plain-Python
Algorithm 1 oracle on the conftest graph (ids and both counters equal)."""

import numpy as np

from repro.core import ref as rref
from repro_torch.core import ref as tref


def test_greedy_beam_search_ref(dataset, graph):
    for qi in range(4):
        args = (dataset.vectors, graph.neighbors, dataset.queries[qi],
                graph.medoid)
        want, wstats = rref.greedy_beam_search_ref(*args, L=32, k=10)
        got, gstats = tref.greedy_beam_search_ref(*args, L=32, k=10)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert gstats == wstats
