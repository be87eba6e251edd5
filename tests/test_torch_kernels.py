"""The port's kernel wrappers on the CPU (their plain versions) against the
reference's Pallas wrappers in interpret mode, bitwise; the build and
launch plumbing that runs without a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, strategies as st

from repro.core import beam_search as rbs, pq as rpq
from repro.kernels.pq_adc.ops import pq_adc_slots_tiled as r_adc_tiled
from repro.kernels.topk.ops import bitonic_topk as r_topk, merge_topk as r_merge
from repro_torch import kernels
from repro_torch.core import beam_search as tbs
from repro_torch.kernels import _build
from repro_torch.kernels.pq_adc.ops import pq_adc_slots_tiled
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


def test_cpu_wrappers_launch_nothing():
    kernels.reset_launch_counts()
    bitonic_topk(torch.zeros((2, 8)), torch.zeros((2, 8), dtype=torch.int32),
                 3)
    pq_adc_slots_tiled(torch.zeros((2, 4, 16)),
                       torch.zeros((2, 8, 4), dtype=torch.uint8))
    assert kernels.launch_counts() == {"pq_adc_slots": 0, "bitonic_topk": 0}


def test_wrappers_validate_shapes():
    with pytest.raises(ValueError, match="k="):
        bitonic_topk(torch.zeros((2, 8)),
                     torch.zeros((2, 8), dtype=torch.int32), 9)
    with pytest.raises(ValueError, match="luts"):
        pq_adc_slots_tiled(torch.zeros((2, 5, 16)),
                           torch.zeros((2, 8, 4), dtype=torch.uint8))


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
