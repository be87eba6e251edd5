"""core/pq.py of the port against the reference: LUT build (rtol 1e-4,
the bar of test_pq_lut_shapes), the i8 wire pair and ADC bitwise, and
codebook training / encoding on the conftest data."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pq as rpq
from repro_torch.core import pq as tpq


@pytest.mark.parametrize("q,m,k,dsub", [
    (8, 8, 64, 4), (37, 16, 256, 6), (128, 32, 256, 4), (1, 4, 16, 8),
])
def test_build_lut_shapes(q, m, k, dsub):
    rng = np.random.default_rng(q * m)
    queries = rng.normal(size=(q, m * dsub)).astype(np.float32)
    cents = rng.normal(size=(m, k, dsub)).astype(np.float32)
    want = np.asarray(rpq.build_lut(jnp.asarray(cents), jnp.asarray(queries)))
    got = tpq.build_lut(torch.tensor(cents), torch.tensor(queries)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_build_lut_on_conftest_codebook(codebook, dataset):
    cents = np.asarray(codebook.centroids)
    want = np.asarray(rpq.build_lut(codebook.centroids,
                                    jnp.asarray(dataset.queries)))
    got = tpq.build_lut(torch.tensor(cents),
                        torch.tensor(dataset.queries)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # record how far from bitwise the einsum lands (LUT bits steer the beam)
    frac_equal = float((got == want).mean())
    print(f"build_lut bitwise-equal fraction: {frac_equal:.4f}")
    assert frac_equal > 0.5


@pytest.mark.parametrize("shape", [(3, 8, 64), (2, 5, 16, 128)])
def test_i8_wire_pair_bitwise(shape):
    rng = np.random.default_rng(len(shape))
    lut = (rng.normal(size=shape) * 5).astype(np.float32)
    lut[..., 0, :] = 0.0                       # an all-zero subspace row
    q_r, s_r = rpq.quantize_lut_i8(jnp.asarray(lut))
    q_t, s_t = tpq.quantize_lut_i8(torch.tensor(lut))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_r))
    np.testing.assert_array_equal(
        tpq.dequantize_lut_i8(q_t, s_t).numpy(),
        np.asarray(rpq.dequantize_lut_i8(q_r, s_r)))


@pytest.mark.parametrize("s,c,m,k", [(8, 64, 16, 128), (6, 70, 8, 64),
                                     (1, 32, 4, 16), (256, 256, 24, 256)])
def test_adc_slots_bitwise(s, c, m, k):
    rng = np.random.default_rng(s + c)
    luts = rng.normal(size=(s, m, k)).astype(np.float32)
    codes = rng.integers(0, k, size=(s, c, m)).astype(np.uint8)
    want = np.asarray(rpq.adc_slots(jnp.asarray(luts), jnp.asarray(codes)))
    got = tpq.adc_slots(torch.tensor(luts), torch.tensor(codes)).numpy()
    np.testing.assert_array_equal(got, want)


def test_adc_bitwise_on_index_codes(codebook, codes, dataset):
    lut = rpq.build_lut(codebook.centroids, jnp.asarray(dataset.queries[:8]))
    want = np.asarray(rpq.adc(lut, jnp.asarray(codes)))
    got = tpq.adc(torch.tensor(np.asarray(lut)),
                  torch.tensor(np.asarray(codes))).numpy()
    np.testing.assert_array_equal(got, want)


def test_train_and_encode_track_reference(dataset, codebook, codes):
    cb = tpq.train(dataset.vectors, m=16, k=128, iters=5, seed=0,
                   device="cpu")
    np.testing.assert_allclose(cb.centroids.numpy(),
                               np.asarray(codebook.centroids),
                               rtol=1e-4, atol=1e-4)
    got = tpq.encode(cb, dataset.vectors).numpy()
    agree = float((got == np.asarray(codes)).mean())
    print(f"PQ code agreement with the reference: {agree:.5f}")
    assert got.dtype == np.uint8 and agree > 0.99


def test_train_samples_like_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(300, 8)).astype(np.float32)
    ref = rpq.train(x, m=4, k=8, iters=3, sample=200, seed=7)
    got = tpq.train(x, m=4, k=8, iters=3, sample=200, seed=7, device="cpu")
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(ref.centroids), rtol=1e-4,
                               atol=1e-4)


def test_reconstruct_on_conftest_codes(codebook, codes):
    """Decoded codes equal the reference's ``reconstruct`` bitwise (a
    gather of centroid rows)."""
    want = np.asarray(rpq.reconstruct(codebook, jnp.asarray(codes[:200])))
    got = tpq.reconstruct(
        tpq.PQCodebook(centroids=torch.tensor(np.asarray(codebook.centroids))),
        torch.tensor(np.asarray(codes[:200]))).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
