"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and nvcc and is marked ``gpu``; on a
host without them each one skips, naming what is missing.  The file
imports neither JAX nor the reference package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from repro_torch.device import gpu_missing


@pytest.fixture
def cuda():
    reason = gpu_missing()
    if reason:
        pytest.skip(f"needs the card: {reason}")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("s,c,m,k", [(256, 256, 24, 256), (8, 64, 16, 128),
                                     (6, 70, 8, 64), (1, 32, 4, 16),
                                     (3, 300, 64, 256)])
def test_adc_kernel_bitwise(cuda, s, c, m, k):
    from repro_torch.kernels.pq_adc.ops import adc_slots_ref, pq_adc_slots_tiled

    g = torch.Generator(device=cuda).manual_seed(s * c)
    luts = torch.randn((s, m, k), generator=g, device=cuda)
    codes = torch.randint(0, k, (s, c, m), generator=g, device=cuda,
                          dtype=torch.uint8)
    before = pq_adc_slots_tiled.launches
    got = pq_adc_slots_tiled(luts, codes)
    torch.cuda.synchronize()
    assert pq_adc_slots_tiled.launches == before + 1
    assert torch.equal(got, adc_slots_ref(luts, codes))


@pytest.mark.gpu
@pytest.mark.parametrize("b,ca,cb,k,dup", [
    (256, 64, 256, 64, False), (256, 256, 8, 256, False),
    (13, 100, 100, 17, True), (1, 7, 0, 7, False), (4, 2000, 1000, 64, True),
])
def test_topk_kernel_bitwise(cuda, b, ca, cb, k, dup):
    from repro_torch.kernels.topk.ops import bitonic_topk, merge_topk, topk_ref

    g = torch.Generator(device=cuda).manual_seed(b * ca + cb)
    if dup:
        vals = torch.randint(0, 4, (b, ca + cb), generator=g,
                             device=cuda).float()
    else:
        vals = torch.randn((b, ca + cb), generator=g, device=cuda)
    idxs = torch.randperm(b * (ca + cb), generator=g, device=cuda).reshape(
        b, ca + cb).to(torch.int32)
    rv, ri = topk_ref(vals, idxs, k)
    ov, oi = bitonic_topk(vals, idxs, k)
    assert torch.equal(ov, rv) and torch.equal(oi, ri)
    if cb:
        mi, mv = merge_topk(idxs[:, :ca].contiguous(), vals[:, :ca].contiguous(),
                            idxs[:, ca:].contiguous(), vals[:, ca:].contiguous(),
                            k)
        assert torch.equal(mv, rv) and torch.equal(mi, ri)


@pytest.mark.gpu
def test_kernel_wrappers_raise_on_what_they_do_not_take(cuda):
    from repro_torch.kernels.pq_adc.ops import pq_adc_slots_tiled
    from repro_torch.kernels.topk.ops import bitonic_topk

    luts = torch.zeros((2, 4, 16), device=cuda)
    with pytest.raises(TypeError):
        pq_adc_slots_tiled(luts, torch.zeros((2, 8, 4), dtype=torch.int32,
                                             device=cuda))
    with pytest.raises(ValueError):
        bitonic_topk(torch.zeros((2, 5000), device=cuda),
                     torch.zeros((2, 5000), dtype=torch.int32, device=cuda), 4)
