"""The port's kernel wrappers on the CPU (their plain versions) against the
reference's Pallas wrappers in interpret mode; the build and launch
plumbing that runs without a card.

Tolerances: the ADC and top-k wrappers and the candidate filter are
bitwise equal to the reference's
(the dense ADC's interpret-mode accumulation 0 + p0 + p1 + ... gives the
gather's left-to-right sum exactly).  The LUT build is a float formula in
another order than XLA's dot: rtol 1e-4, atol 1e-4, the reference's own
bar for its kernel (``tests/test_kernels.py::test_pq_lut_shapes``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, strategies as st

from repro.core import beam_search as rbs, pq as rpq
from repro.kernels.pq_adc.ops import (
    pq_adc as r_adc, pq_adc_slots as r_adc_slots,
    pq_adc_slots_tiled as r_adc_tiled)
from repro.kernels.pq_lut.ops import pq_lut as r_lut
from repro.kernels.topk.ops import bitonic_topk as r_topk, merge_topk as r_merge
from repro_torch import kernels
from repro_torch.core import beam_search as tbs
from repro_torch.kernels import _build
from repro_torch.core import pq as tpq
from repro_torch.kernels.cand_filter.ops import filter_known
from repro_torch.kernels.pq_adc.ops import (
    pq_adc, pq_adc_slots, pq_adc_slots_tiled)
from repro_torch.kernels.pq_lut.ops import pq_lut
from repro_torch.kernels.topk.ops import bitonic_topk, merge_topk


@pytest.mark.parametrize("s,c,m,k", [(8, 64, 16, 128), (6, 70, 8, 64),
                                     (1, 32, 4, 16)])
def test_adc_slots_tiled_bitwise_vs_pallas(s, c, m, k):
    rng = np.random.default_rng(s * c)
    luts = rng.normal(size=(s, m, k)).astype(np.float32)
    codes = rng.integers(0, k, size=(s, c, m)).astype(np.int32)
    pallas = np.asarray(r_adc_tiled(jnp.asarray(luts), jnp.asarray(codes)))
    gather = np.asarray(rpq.adc_slots(jnp.asarray(luts), jnp.asarray(codes)))
    got = pq_adc_slots_tiled(torch.tensor(luts), torch.tensor(codes)).numpy()
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, gather)


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("q,n,m,k", [
    (8, 64, 8, 64), (37, 333, 16, 256), (130, 512, 32, 128),
])
def test_pq_adc_bitwise_vs_pallas(q, n, m, k, dtype):
    """The dense ADC at the shapes of tests/test_kernels.py::
    test_pq_adc_shapes: equal to the Pallas kernel and to the gather."""
    rng = np.random.default_rng(n)
    lut = rng.normal(size=(q, m, k)).astype(np.float32)
    codes = rng.integers(0, k, size=(n, m)).astype(dtype)
    pallas = np.asarray(r_adc(jnp.asarray(lut), jnp.asarray(codes)))
    got = pq_adc(torch.tensor(lut), torch.tensor(codes)).numpy()
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(
        got, np.asarray(rpq.adc(jnp.asarray(lut), jnp.asarray(codes))))
    # the leading batch axis: two blocks at once, each its own product
    both = pq_adc(torch.tensor(np.stack([lut, lut[::-1].copy()])),
                  torch.tensor(np.stack([codes, codes])))
    np.testing.assert_array_equal(both[0].numpy(), pallas)
    np.testing.assert_array_equal(both[1].numpy(), pallas[::-1])


@pytest.mark.parametrize("s,c,m,k", [(8, 64, 16, 128), (6, 70, 8, 64),
                                     (1, 32, 4, 16)])
def test_pq_adc_slots_bitwise_vs_pallas(s, c, m, k):
    """The dense route's slot contract (score every pair of the block, keep
    the diagonal), in one block or split into per-partition blocks."""
    rng = np.random.default_rng(s * c)
    luts = rng.normal(size=(s, m, k)).astype(np.float32)
    codes = rng.integers(0, k, size=(s, c, m)).astype(np.int32)
    want = np.asarray(r_adc_slots(jnp.asarray(luts), jnp.asarray(codes)))
    tl, tc = torch.tensor(luts), torch.tensor(codes)
    np.testing.assert_array_equal(pq_adc_slots(tl, tc).numpy(), want)
    groups = 2 if s % 2 == 0 else 1
    np.testing.assert_array_equal(
        pq_adc_slots(tl, tc, groups=groups).numpy(), want)
    np.testing.assert_array_equal(pq_adc_slots_tiled(tl, tc).numpy(), want)


@pytest.mark.parametrize("q,m,k,dsub", [
    (8, 8, 64, 4), (37, 16, 256, 6), (128, 32, 256, 4), (1, 4, 16, 8),
])
def test_pq_lut_vs_pallas(q, m, k, dsub):
    """The LUT build at the shapes of tests/test_kernels.py::
    test_pq_lut_shapes, rtol 1e-4, atol 1e-4; its plain version is the
    kernel's fixed order, so each entry is independent of the batch."""
    rng = np.random.default_rng(q * m)
    queries = rng.normal(size=(q, m * dsub)).astype(np.float32)
    cents = rng.normal(size=(m, k, dsub)).astype(np.float32)
    want = np.asarray(r_lut(jnp.asarray(queries), jnp.asarray(cents)))
    got = pq_lut(torch.tensor(queries), torch.tensor(cents))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        pq_lut(torch.tensor(queries[-1:]), torch.tensor(cents)).numpy(),
        got[-1:].numpy())
    np.testing.assert_array_equal(
        tpq.build_lut(torch.tensor(cents), torch.tensor(queries),
                      impl="kernel").numpy(), got.numpy())


@pytest.mark.parametrize("b,c,k", [(4, 16, 4), (13, 200, 17), (8, 1024, 64),
                                   (1, 7, 7)])
def test_topk_shapes_bitwise_vs_pallas(b, c, k):
    rng = np.random.default_rng(b * c)
    vals = rng.normal(size=(b, c)).astype(np.float32)
    idxs = rng.permutation(np.arange(b * c)).reshape(b, c).astype(np.int32)
    rv, ri = r_topk(jnp.asarray(vals), jnp.asarray(idxs), k)
    ov, oi = bitonic_topk(torch.tensor(vals), torch.tensor(idxs), k)
    np.testing.assert_array_equal(ov.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(oi.numpy(), np.asarray(ri))


@settings(max_examples=25, deadline=None)
@given(
    b=st.integers(1, 6), c=st.integers(2, 96), k=st.integers(1, 16),
    dup=st.booleans(), seed=st.integers(0, 2**16),
)
def test_topk_property_bitwise_vs_pallas(b, c, k, dup, seed):
    """Any shape, incl. heavy duplicate values (ties broken by index)."""
    k = min(k, c)
    rng = np.random.default_rng(seed)
    if dup:
        vals = rng.integers(0, 4, size=(b, c)).astype(np.float32)
    else:
        vals = rng.normal(size=(b, c)).astype(np.float32)
    idxs = rng.permutation(np.arange(b * c)).reshape(b, c).astype(np.int32)
    rv, ri = r_topk(jnp.asarray(vals), jnp.asarray(idxs), k)
    ov, oi = bitonic_topk(torch.tensor(vals), torch.tensor(idxs), k)
    np.testing.assert_array_equal(ov.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(oi.numpy(), np.asarray(ri))


@pytest.mark.parametrize("b,ca,cb,k", [(3, 64, 256, 64), (2, 256, 8, 256)])
def test_merge_topk_bitwise_vs_pallas(b, ca, cb, k):
    """The two main-path merges: beam (L + W·R) and pool (pool + W), with
    the merges' repeated (INF, -2) padding pairs."""
    rng = np.random.default_rng(ca)
    ids = rng.permutation(np.arange(b * (ca + cb))).reshape(b, -1)
    ids = ids.astype(np.int32)
    dists = rng.integers(0, 8, size=(b, ca + cb)).astype(np.float32)
    ids[:, ca - 5:ca] = -2
    dists[:, ca - 5:ca] = np.inf
    a = (ids[:, :ca], dists[:, :ca], ids[:, ca:], dists[:, ca:])
    ri, rd = r_merge(*map(jnp.asarray, a), k)
    oi, od = merge_topk(*map(torch.tensor, a), k)
    np.testing.assert_array_equal(oi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(od.numpy(), np.asarray(rd))


@settings(max_examples=25, deadline=None)
@given(L=st.sampled_from([8, 16]), c=st.integers(1, 12),
       seed=st.integers(0, 2**16))
def test_bitonic_merge_packed_flags_bit_identical(L, c, seed):
    """The bitonic beam merge carries explored flags in the payload's low
    bit; (ids, dists, expl) must equal the reference's, ties included."""
    rng = np.random.default_rng(seed)
    bids = rng.choice(1000, size=L, replace=False).astype(np.int32)
    n_pad = rng.integers(0, L // 2 + 1)
    bids[L - n_pad:] = -1
    bdists = np.where(bids < 0, np.inf,
                      rng.integers(0, 4, size=L) * 0.5).astype(np.float32)
    bexpl = np.where(bids < 0, False, rng.random(L) < 0.5)
    order = np.lexsort((bids, bdists))
    bids, bdists, bexpl = bids[order], bdists[order], bexpl[order]
    cids = (1000 + rng.choice(1000, size=c, replace=False)).astype(np.int32)
    cdists = (rng.integers(0, 4, size=c) * 0.5).astype(np.float32)
    args = (bids[None], bdists[None], bexpl[None], cids[None], cdists[None])
    want = rbs.merge_into_beam_fused(*map(jnp.asarray, args), impl="bitonic")
    got = tbs.merge_into_beam_fused(*map(torch.tensor, args), impl="bitonic")
    lex = tbs.merge_into_beam_fused(*map(torch.tensor, args), impl="lexsort")
    for w, g, x in zip(want, got, lex):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(x.numpy(), np.asarray(w))


def _filter_case(rng, b, c, ha, hb, ids):
    """Candidates and two haystacks drawn from ``ids`` ids, so that ids
    repeat within each and across them, with NO_ID padding in all three
    and row 0 of the candidates all NO_ID."""
    def draw(w):
        x = rng.integers(0, ids, size=(b, w)).astype(np.int32)
        x[rng.random((b, w)) < 0.2] = -1
        x[:, w - 1:] = x[:, :min(w, 1)]       # a repeat in every row
        return x

    cand, a, h = draw(c), draw(ha), draw(hb)
    cand[0] = -1
    return cand, a, h


def _filter_jax(cand, a, h):
    c = jnp.asarray(cand)
    known = (rbs._contains_rows(jnp.asarray(a), c)
             | rbs._contains_rows(jnp.asarray(h), c))
    return np.asarray(jnp.where(known, -1, c))


@pytest.mark.parametrize("c,ha,hb", [(256, 64, 256), (32, 16, 64), (1, 3, 5)])
def test_filter_known_bitwise_vs_jax(c, ha, hb):
    """The engine's step (W·R = 256 against L = 64 and the pool of 256),
    the head search's hop (R = 32 against L = 16 and 64 visited) and a
    ragged shape: NO_ID padding in all three inputs, ids repeated within a
    haystack and within the candidates, an all-NO_ID row."""
    rng = np.random.default_rng(c + ha + hb)
    cand, a, h = _filter_case(rng, 5, c, ha, hb, ids=max(8, c + ha))
    got = filter_known(*map(torch.tensor, (cand, a, h)))
    want = _filter_jax(cand, a, h)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1).any() and (want[1:] != -1).any()
    assert (got[0] == -1).all()


@settings(max_examples=12, deadline=None)
@given(c=st.sampled_from([1, 5, 40]), ha=st.sampled_from([0, 3, 16]),
       hb=st.sampled_from([0, 7]), ids=st.integers(1, 64),
       seed=st.integers(0, 2**16))
def test_filter_known_property_vs_jax(c, ha, hb, ids, seed):
    """Ragged and empty widths, and any density of hits (widths from a few
    values, so that the reference's shapes repeat and it compiles little)."""
    cand, a, h = _filter_case(np.random.default_rng(seed), 3, c, ha, hb, ids)
    got = filter_known(*map(torch.tensor, (cand, a, h)))
    np.testing.assert_array_equal(got.numpy(), _filter_jax(cand, a, h))


def test_cpu_wrappers_launch_nothing():
    kernels.reset_launch_counts()
    bitonic_topk(torch.zeros((2, 8)), torch.zeros((2, 8), dtype=torch.int32),
                 3)
    pq_adc_slots_tiled(torch.zeros((2, 4, 16)),
                       torch.zeros((2, 8, 4), dtype=torch.uint8))
    pq_adc(torch.zeros((2, 4, 16)), torch.zeros((8, 4), dtype=torch.uint8))
    pq_lut(torch.zeros((2, 8)), torch.zeros((2, 16, 4)))
    ids = torch.zeros((2, 8), dtype=torch.int32)
    filter_known(ids, ids[:, :3].contiguous(), ids)
    assert kernels.launch_counts() == {"pq_adc_slots": 0, "bitonic_topk": 0,
                                       "pq_adc": 0, "pq_lut": 0,
                                       "cand_filter": 0}


def test_wrappers_validate_shapes():
    with pytest.raises(ValueError, match="k="):
        bitonic_topk(torch.zeros((2, 8)),
                     torch.zeros((2, 8), dtype=torch.int32), 9)
    with pytest.raises(ValueError, match="luts"):
        pq_adc_slots_tiled(torch.zeros((2, 5, 16)),
                           torch.zeros((2, 8, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="lut"):
        pq_adc(torch.zeros((2, 4, 16)), torch.zeros((8, 5), dtype=torch.uint8))
    with pytest.raises(ValueError, match="groups"):
        pq_adc_slots(torch.zeros((3, 4, 16)),
                     torch.zeros((3, 8, 4), dtype=torch.uint8), groups=2)
    with pytest.raises(ValueError, match="queries"):
        pq_lut(torch.zeros((2, 9)), torch.zeros((2, 16, 4)))
    with pytest.raises(ValueError, match="lut impl"):
        tpq.build_lut(torch.zeros((2, 16, 4)), torch.zeros((2, 8)),
                      impl="dense")
    ids = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        filter_known(ids, ids.long(), ids)
    with pytest.raises(ValueError, match="B = 2"):
        filter_known(ids, torch.zeros((3, 8), dtype=torch.int32), ids)
    with pytest.raises(ValueError, match="contiguous"):
        filter_known(ids, torch.zeros((8, 2), dtype=torch.int32).t(), ids)
    with pytest.raises(ValueError, match="one device"):
        filter_known(ids, ids, ids.to("meta"))


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """A build that cannot run raises; nothing falls back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: None)
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["topk"])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("pq_adc")


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such card' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    with pytest.raises(RuntimeError, match="nvcc exit 3"):
        _build.build()
    assert not list((tmp_path / "out").glob("*.so"))


def test_library_names_follow_source_and_flags():
    for name in _build.SOURCES:
        assert _build.source_path(name).is_file()
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path == _build.library_path(name)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_launch_counts_survive_threads():
    """Worker threads launch at once; a lost update would drop counts."""
    import sys
    import threading

    kernels.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch(pq_lut) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert kernels.launch_counts()["pq_lut"] == 16 * 2000
    kernels.reset_launch_counts()
