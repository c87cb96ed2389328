"""The CUDA kernels against their plain versions, on the card.

These tests carry the ``cuda`` marker and skip without a CUDA device;
on the card they run with

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

This file imports neither JAX nor ``repro``, so it runs where only the
port is installed.  Tolerance rtol 1e-5 / atol 1e-4 (gram) and 1e-5
(sddmm): fp32 on both sides, summed in another order; topk_score is
held by ``ref.check_topk_score``, whose comment states its tolerance.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gram as tgram
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sddmm as tsddmm
from repro_torch.kernels import topk_score as ttopk

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


def _topk_inputs(B, S, N, K, seed=0, excl_frac=0.0):
    rng = np.random.default_rng(seed)
    us = rng.normal(size=(B, S, K)).astype(np.float32)
    v = rng.normal(size=(S, N, K)).astype(np.float32)
    excl = (rng.random((B, N)) < excl_frac).astype(np.float32)
    return us, v, excl


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,N,K,k,excl_frac", [
    (8, 32, 4096, 32, 100, 0.0), (4, 64, 2048, 64, 100, 0.0),
    (3, 8, 130, 16, 7, 0.5), (1, 1, 1, 1, 1, 0.0), (2, 3, 50, 7, 50, 0.9),
    (2, 5, 70000, 12, 300, 0.1), (3, 6, 5000, 130, 1024, 0.0),
    (8, 32, 8192, 128, 100, 0.01)])
def test_topk_kernel_matches_plain(cuda, B, S, N, K, k, excl_frac):
    us, v, excl = _t(*_topk_inputs(B, S, N, K, excl_frac=excl_frac),
                     device=cuda)
    before = ttopk.launches
    got = tops.topk_score(us, v, k, exclude=excl)
    torch.cuda.synchronize()
    assert ttopk.launches == before + 1
    tops.reset_launch_counts()
    want = tops.topk_score(us.cpu(), v.cpu(), k, exclude=excl.cpu())
    assert tops.launch_counts()["topk_score"] == 0
    tref.check_topk_score([x.cpu() for x in got], want, us.cpu(), v.cpu())


@pytest.mark.cuda
def test_topk_kernel_batch_invariant_and_deterministic(cuda):
    """A batched call is the same bits as one call per user, whatever
    chunk size each picks, and as itself run again."""
    us, v, excl = _t(*_topk_inputs(8, 32, 8192, 128, excl_frac=0.01),
                     device=cuda)
    batched = tops.topk_score(us, v, 100, exclude=excl)
    again = tops.topk_score(us, v, 100, exclude=excl)
    for x, y in zip(batched, again):
        assert torch.equal(x, y)
    for b in range(8):
        one = tops.topk_score(us[b:b + 1], v, 100, exclude=excl[b:b + 1])
        for x, y in zip(batched, one):
            assert torch.equal(x[b:b + 1], y)


@pytest.mark.cuda
def test_topk_kernel_ties_go_to_the_lowest_id(cuda):
    """Duplicated item rows and +-0.0 means tie exactly; the lowest item
    id comes first, as in the plain version."""
    us, v, _ = _topk_inputs(2, 4, 3000, 8)
    v[:, 2000:2600] = v[:, 100:700]          # duplicates of lower ids
    v[:, 1500:1510] = 0.0
    v[:, 1510:1520] = -0.0
    us_t, v_t = _t(us, v, device=cuda)
    ids, mean, _ = tops.topk_score(us_t, v_t, 1000)
    wids, _, _ = tops.topk_score(torch.from_numpy(us),
                                 torch.from_numpy(v), 1000)
    assert torch.equal(ids.cpu(), wids)
    for b in range(2):
        row = ids[b].tolist()
        for d in range(2000, 2600):
            if d in row:
                assert d - 1900 in row and \
                    row.index(d - 1900) < row.index(d)
    # an item with mean -0.0 or +0.0 ranks among its zero-mean peers
    # by id alone
    neg = torch.full((1, 1, 1), -1.0, device=cuda)
    zeros = torch.zeros((1, 6, 1), device=cuda)
    zeros[0, 1::2] = -0.0
    zids, _, _ = tops.topk_score(neg, zeros, 6)
    assert zids.tolist() == [[0, 1, 2, 3, 4, 5]]


@pytest.mark.cuda
def test_topk_kernel_refuses_what_it_does_not_take(cuda):
    us, v, excl = _t(*_topk_inputs(2, 4, 3000, 8), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ttopk.topk_score_cuda(us.bfloat16(), v, excl, 5)
    with pytest.raises(ValueError, match="not contiguous"):
        ttopk.topk_score_cuda(us.transpose(1, 2), v, excl, 5)
    with pytest.raises(ValueError, match="chunk"):
        ttopk.topk_score_cuda(us, v, excl, 1025)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        ttopk.topk_score_cuda(us.cpu(), v, excl, 5)
