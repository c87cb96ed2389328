"""The CUDA kernels against their plain versions, on the card.

These tests carry the ``cuda`` marker and skip without a CUDA device;
on the card they run with

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

This file imports neither JAX nor ``repro``, so it runs where only the
port is installed.  Tolerance rtol 1e-5 / atol 1e-4 (gram) and 1e-5
(sddmm): fp32 on both sides, summed in another order.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gram as tgram
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sddmm as tsddmm

GRAM_TOL = dict(rtol=1e-5, atol=1e-4)
SDDMM_TOL = dict(rtol=1e-5, atol=1e-5)


def _gram_inputs(R, T, K, seed=0):
    rng = np.random.default_rng(seed)
    vg = rng.normal(size=(R, T, K)).astype(np.float32)
    val = rng.normal(size=(R, T)).astype(np.float32)
    mask = (rng.random((R, T)) > 0.3).astype(np.float32)
    return vg, val, mask


def _sddmm_inputs(E, K, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(E, K)).astype(np.float32),
            rng.normal(size=(E, K)).astype(np.float32))


def _t(*arrays, device):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R,T,K", [(1, 1, 1), (64, 256, 128),
                                   (13, 257, 33), (3, 5, 130),
                                   (4, 70, 300), (2, 33, 257),
                                   (5, 1, 128), (6, 17, 64)])
def test_gram_kernel_matches_plain(cuda, R, T, K):
    vg, val, mask = _t(*_gram_inputs(R, T, K), device=cuda)
    before = tgram.launches
    g, r = tops.gram_and_rhs(vg, val, mask)
    torch.cuda.synchronize()
    # one kernel for the diagonal tiles, one more for those below them
    assert tgram.launches == before + (1 if K <= tgram.TILE else 2)
    gw, rw = tref.gram_ref(vg, val, mask)
    torch.testing.assert_close(g, gw, **GRAM_TOL)
    torch.testing.assert_close(r, rw, **GRAM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("E,K", [(1, 3), (4096, 128), (1025, 200)])
def test_sddmm_kernel_matches_plain(cuda, E, K):
    u, v = _t(*_sddmm_inputs(E, K), device=cuda)
    before = tsddmm.launches
    p = tops.sddmm(u, v)
    torch.cuda.synchronize()
    assert tsddmm.launches == before + 1
    torch.testing.assert_close(p, tref.sddmm_ref(u, v), **SDDMM_TOL)


@pytest.mark.cuda
def test_kernels_refuse_bf16(cuda):
    vg, val, mask = _t(*_gram_inputs(2, 3, 4), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        tgram.gram_cuda(vg.bfloat16(), val, mask)
    u, v = _t(*_sddmm_inputs(5, 4), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        tsddmm.sddmm_cuda(u.bfloat16(), v.bfloat16())


@pytest.mark.cuda
def test_gram_kernel_is_deterministic_and_symmetric(cuda):
    vg, val, mask = _t(*_gram_inputs(8, 300, 256), device=cuda)
    g1, r1 = tgram.gram_cuda(vg, val, mask)
    g2, r2 = tgram.gram_cuda(vg, val, mask)
    assert torch.equal(g1, g2) and torch.equal(r1, r2)
    assert torch.equal(g1, g1.mT)
