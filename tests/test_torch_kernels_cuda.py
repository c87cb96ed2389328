"""The CUDA kernels against their plain versions, on the card.

These tests carry the ``cuda`` marker and skip without a CUDA device;
on the card they run with

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

This file imports neither JAX nor ``repro``, so it runs where only the
port is installed.  Tolerance rtol 1e-5 / atol 1e-4 (gram) and 1e-5
(sddmm): fp32 on both sides, summed in another order; topk_score is
held by ``ref.check_topk_score``, flash by ``ref.check_attention`` and
``ref.check_lse``, flash_bwd by ``ref.check_attention_bwd`` (and its
Hopper design against its first design, ``csrc/flash_bwd.cu``,
by ``ref.check_bwd_close``), whose comments state their tolerances.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash as tflash
from repro_torch.kernels import flash_bwd as tflash_bwd
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
    before = tgram.launches["gram"]
    g, r = tops.gram_and_rhs(vg, val, mask)
    torch.cuda.synchronize()
    # one kernel for the diagonal tiles, one more for those below them
    assert tgram.launches["gram"] == before + (1 if K <= tgram.TILE else 2)
    gw, rw = tref.gram_ref(vg, val, mask)
    torch.testing.assert_close(g, gw, **GRAM_TOL)
    torch.testing.assert_close(r, rw, **GRAM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("E,K", [(1, 3), (4096, 128), (1025, 200)])
def test_sddmm_kernel_matches_plain(cuda, E, K):
    u, v = _t(*_sddmm_inputs(E, K), device=cuda)
    before = tsddmm.launches["sddmm"]
    p = tops.sddmm(u, v)
    torch.cuda.synchronize()
    assert tsddmm.launches["sddmm"] == before + 1
    torch.testing.assert_close(p, tref.sddmm_ref(u, v), **SDDMM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gram", "sddmm"])
def test_kernels_refuse_bf16(cuda, kernel):
    """Both take bf16 operands now, the reference's bf16 branches, and
    refuse the pairs no reference path makes.  sddmm: bf16 x bf16 at
    its probe shapes and a K that is not a multiple of 4, one launch of
    ``sddmm_bf16`` a call, matching its plain version and bitwise the
    fp32 kernel on the widened operands (the same columns a lane, in
    the same order); bf16 against fp32 raises.  gram: the reference's
    bf16 probe, and a K that is not a multiple of 8, whose rows the
    kernel loads element-wise, against the bf16 branch of its plain
    version."""
    if kernel == "sddmm":
        for E, K in (*tops.KERNELS["sddmm_bf16"].values(), (37, 9)):
            u, v = (x.bfloat16() for x in
                    _t(*_sddmm_inputs(E, K), device=cuda))
            before = tsddmm.launches["sddmm_bf16"]
            p = tops.sddmm(u, v)
            torch.cuda.synchronize()
            assert tsddmm.launches["sddmm_bf16"] == before + 1
            torch.testing.assert_close(p, tref.sddmm_ref(u, v),
                                       **SDDMM_TOL)
            assert _same_bits(p, tsddmm.sddmm_cuda(u.float(), v.float()))
        with pytest.raises(TypeError, match="float32 x float32"):
            tsddmm.sddmm_cuda(u, v.float())
        return
    for R, T, K in ((16, 130, 32), (5, 37, 9)):
        vg, val, mask = (x.bfloat16() for x in
                         _t(*_gram_inputs(R, T, K), device=cuda))
        before = tgram.launches["gram"]
        g, r = tops.gram_and_rhs(vg, val, mask)
        torch.cuda.synchronize()
        assert tgram.launches["gram"] == before + 1
        assert g.dtype == r.dtype == torch.float32
        gw, rw = tref.gram_ref(vg, val, mask)
        torch.testing.assert_close(g, gw, **GRAM_TOL)
        torch.testing.assert_close(r, rw, **GRAM_TOL)


@pytest.mark.cuda
def test_gram_kernel_is_deterministic_and_symmetric(cuda):
    vg, val, mask = _t(*_gram_inputs(8, 300, 256), device=cuda)
    g1, r1 = tgram.gram_cuda(vg, val, mask)
    g2, r2 = tgram.gram_cuda(vg, val, mask)
    assert torch.equal(g1, g2) and torch.equal(r1, r2)
    assert torch.equal(g1, g1.mT)


def _gathered_inputs(R, T, K, n_fixed, empty, device, seed=0):
    rng = np.random.default_rng(seed)
    fixed = rng.normal(size=(n_fixed, K)).astype(np.float32)
    idx = rng.integers(0, n_fixed, size=(R, T)).astype(np.int32)
    val = rng.normal(size=(R, T)).astype(np.float32)
    mask = (rng.random((R, T)) > 0.3).astype(np.float32)
    mask[:empty] = 0.0
    return _t(fixed, idx, val, mask, device=device)


def _first_design(name="gram_v1"):
    """scripts_dev/<name>.py, a kernel's first design, registered."""
    import importlib
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]
                           / "scripts_dev"))
    module = importlib.import_module(name)
    module.register()
    return module


# K = 1, 7, 33, 128 and 256 (the tiled path); T not a multiple of the
# 32-step stage; R = 300 not a multiple of the persistent grid's groups
@pytest.mark.cuda
@pytest.mark.parametrize("R,T,K,n_fixed,empty", [
    (3, 5, 1, 4, 1), (9, 37, 7, 20, 2), (13, 257, 33, 50, 3),
    (300, 70, 128, 1000, 5), (4, 40, 256, 30, 1)])
def test_gathered_gram_kernel_matches_plain(cuda, R, T, K, n_fixed, empty):
    """Two blocks' order: the first without acc, the second with it and
    a Lambda_p that is not symmetric, against ``ref.gathered_gram_ref``
    at GRAM_TOL; one launch a call for K <= 128, two above."""
    f1, i1, v1, m1 = _gathered_inputs(R, T, K, n_fixed, empty, cuda, 0)
    f2, i2, v2, m2 = _gathered_inputs(R, T + 3, K, n_fixed, 0, cuda, 1)
    a1 = torch.tensor(1.7, device=cuda)
    a2 = torch.tensor(0.45, device=cuda)
    lam = torch.randn(K, K, device=cuda)
    before = tgram.launches["gram"]
    acc = tops.gathered_gram_and_rhs(f1, i1, v1, m1, a1)
    g, r = tops.gathered_gram_and_rhs(f2, i2, v2, m2, a2, acc=acc, lam=lam)
    torch.cuda.synchronize()
    assert tgram.launches["gram"] == before + 2 * (1 if K <= tgram.TILE else 2)
    assert g.data_ptr() == acc[0].data_ptr()
    w1 = tref.gathered_gram_ref(f1.cpu(), i1.cpu(), v1.cpu(), m1.cpu(),
                                a1.cpu())
    gw, rw = tref.gathered_gram_ref(f2.cpu(), i2.cpu(), v2.cpu(), m2.cpu(),
                                    a2.cpu(), acc=w1, lam=lam.cpu())
    torch.testing.assert_close(g.cpu(), gw, **GRAM_TOL)
    torch.testing.assert_close(r.cpu(), rw, **GRAM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("R,T,K", [(300, 64, 128), (40, 1150, 128),
                                   (7, 40, 256), (13, 257, 33)])
def test_gathered_gram_kernel_is_the_first_designs_bits(cuda, R, T, K):
    """With masks of 0 and 1 the fused kernel gives the bits of the
    pipeline it replaces: gather, the first design
    (scripts_dev/gram_v1.cu), mul_ by alpha, add_ of acc, add_ of
    Lambda_p; and the same bits on a second run."""
    prev = _first_design()
    fixed, idx, val, mask = _gathered_inputs(R, T, K, 500, 2, cuda)
    alpha = torch.tensor(2.3, device=cuda)
    lam = torch.randn(K, K, device=cuda)
    accs = (torch.randn(R, K, K, device=cuda), torch.randn(R, K, device=cuda))
    for acc in (None, accs):
        want = prev.pipeline(fixed, idx, val, mask, alpha, lam=lam,
                             acc=None if acc is None else
                             tuple(a.clone() for a in acc))
        runs = [tops.gathered_gram_and_rhs(
            fixed, idx, val, mask, alpha, lam=lam,
            acc=None if acc is None else tuple(a.clone() for a in acc))
            for _ in range(2)]
        torch.cuda.synchronize()
        for got in runs:
            for a, b in zip(got, want):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_gathered_gram_symmetry_and_lam_per_place(cuda):
    """alpha * g is symmetric to the bit; Lambda_p is added at each
    place's own index: with a Lambda_p that is not symmetric the result
    is (alpha * g) + Lambda_p place by place, and with a symmetric one
    it stays symmetric."""
    fixed, idx, val, mask = _gathered_inputs(200, 90, 128, 700, 3, cuda)
    alpha = torch.tensor(0.8, device=cuda)
    g0, _ = tops.gathered_gram_and_rhs(fixed, idx, val, mask, alpha)
    lam = torch.randn(128, 128, device=cuda)
    g1, _ = tops.gathered_gram_and_rhs(fixed, idx, val, mask, alpha,
                                       lam=lam)
    sym = lam + lam.T
    g2, _ = tops.gathered_gram_and_rhs(fixed, idx, val, mask, alpha,
                                       lam=sym)
    torch.cuda.synchronize()
    assert torch.equal(g0, g0.mT)
    assert torch.equal(g1, g0 + lam)
    assert not torch.equal(g1, g1.mT)
    assert torch.equal(g2, g2.mT)


@pytest.mark.cuda
def test_gathered_gram_reads_zeros_for_an_idx_out_of_range(cuda):
    """An idx outside [0, n_fixed) is never read: the kernel takes its
    row as zeros (the plain version would raise)."""
    fixed, idx, val, mask = _gathered_inputs(50, 40, 128, 100, 0, cuda)
    bad = idx.clone()
    bad[::3, ::5] = 100
    bad[1::3, 2::7] = -4
    g, r = tops.gathered_gram_and_rhs(fixed, bad, val, mask, 1.5)
    zero = torch.cat([fixed, torch.zeros(1, 128, device=cuda)])
    safe = torch.where((bad < 0) | (bad >= 100), 100, bad).int()
    gw, rw = tref.gathered_gram_ref(zero, safe, val, mask,
                                    torch.tensor(1.5, device=cuda))
    torch.cuda.synchronize()
    torch.testing.assert_close(g, gw, **GRAM_TOL)
    torch.testing.assert_close(r, rw, **GRAM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["pre-gathered", "gathered"])
@pytest.mark.parametrize("K", [33, 128, 256])
def test_gram_kernels_answer_rows_of_no_steps(cuda, entry, K):
    """T = 0: both entries return (and do not hang), the Gram and rhs of
    no steps, with alpha, acc and lam applied as the plain version does."""
    R = 5
    fixed, idx, val, mask = _gathered_inputs(R, 0, K, 10, 0, cuda)
    if entry == "pre-gathered":
        vg = torch.zeros(R, 0, K, device=cuda)
        g, r = tops.gram_and_rhs(vg, val, mask)
        gw, rw = tref.gram_ref(vg, val, mask)
    else:
        alpha = torch.tensor(1.3, device=cuda)
        lam = torch.randn(K, K, device=cuda)
        acc = (torch.randn(R, K, K, device=cuda),
               torch.randn(R, K, device=cuda))
        g, r = tops.gathered_gram_and_rhs(
            fixed, idx, val, mask, alpha, lam=lam,
            acc=tuple(a.clone() for a in acc))
        gw, rw = tref.gathered_gram_ref(fixed, idx, val, mask, alpha,
                                        lam=lam, acc=acc)
    torch.cuda.synchronize()
    torch.testing.assert_close(g, gw, **GRAM_TOL)
    torch.testing.assert_close(r, rw, **GRAM_TOL)


def _gathered_sddmm_inputs(E, K, n_u, n_v, device, seed=0):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_u, K)).astype(np.float32)
    V = rng.normal(size=(n_v, K)).astype(np.float32)
    i = rng.integers(0, n_u, E).astype(np.int32)
    j = rng.integers(0, n_v, E).astype(np.int32)
    return _t(U, V, i, j, device=device)


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


# (E, K, rows of U, rows of V, run lengths of i; see ops.KERNELS): the
# probes; E = 0; K = 1, 4, 20, 33, 128, 130 and 520 (one and several
# blocks of columns a lane); random i; sorted runs of 64 and 1,144;
# single-entry runs; uneven runs that end inside the 32-entry tiles
# and cross the warps' ranges; E above the entries one wave of warps
# takes in one tile each
@pytest.mark.cuda
@pytest.mark.parametrize("E,K,n_u,n_v,runs", [
    *tops.KERNELS["sddmm_gathered"].values(),
    (0, 128, 5, 5, None), (1, 1, 1, 1, None), (3000, 33, 7, 3000, None),
    (777, 4, 2, 3, None), (2049, 130, 50, 40, None),
    (64 * 129, 128, 129, 8192, 64), (1144 * 20, 128, 20, 4096, 1144),
    (5000, 128, 5000, 300, 1), (3000, 4, 200, 50, (1, 70)),
    (3000, 130, 200, 50, (1, 70)), (3000, 520, 200, 50, (1, 70)),
    (200_000, 128, 20_000, 8192, (20, 45)),
    (8_388_608 + 8_195, 20, 8192, 131072, None)])
def test_gathered_sddmm_matches_plain_and_the_pipeline_bitwise(
        cuda, E, K, n_u, n_v, runs):
    """The fused-gather entry against its plain version (SDDMM_TOL) and
    bitwise against ``index_select`` x 2 + ``sddmm_f32``, the pipeline
    before it, and against its first design (``scripts_dev/sddmm_v1``):
    the same per-entry program over the same rows, whatever the order
    and the runs of i."""
    prev = _first_design("sddmm_v1")
    U, V, i, j = tops.gathered_sddmm_probe(E, K, n_u, n_v, runs, cuda)
    before = tsddmm.launches["sddmm_gathered"]
    p = tops.gathered_sddmm(U, V, i, j)
    torch.cuda.synchronize()
    assert tsddmm.launches["sddmm_gathered"] == before + 1
    assert p.shape == (E,)
    torch.testing.assert_close(p, tref.gathered_sddmm_ref(U, V, i, j),
                               **SDDMM_TOL)
    two_step = tsddmm.sddmm_cuda(U.index_select(0, i), V.index_select(0, j))
    assert _same_bits(p, two_step)
    assert _same_bits(p, prev.gathered(U, V, i, j))


@pytest.mark.cuda
@pytest.mark.parametrize("E,n_u,n_v,runs", [
    (8_388_608 + 8_195, 131_328, 8192, 64), (8192 * 1144, 8192, 131072, 1144)])
def test_gathered_sddmm_sweep_sized_runs_are_the_pipelines_bits(
        cuda, E, n_u, n_v, runs):
    """The sweeps' sizes at K = 128: runs of 64 over more entries than
    one wave of warps takes in one tile each (the observed entries), and
    runs of 1,144 over the 131,072-row factor (probit's columns side):
    bitwise ``index_select`` x 2 + ``sddmm_f32`` and the first design;
    against the plain version within SDDMM_TOL of the sum of the terms'
    magnitudes (fp32 sums in another order; at K = 128 some entries
    cancel to near 0, so the tolerance scales with the terms, as
    ``chip_smoke.max_err`` does)."""
    prev = _first_design("sddmm_v1")
    U, V, i, j = tops.gathered_sddmm_probe(E, 128, n_u, n_v, runs, cuda)
    p = tops.gathered_sddmm(U, V, i, j)
    torch.cuda.synchronize()
    ug, vg = U.index_select(0, i), V.index_select(0, j)
    assert _same_bits(p, tsddmm.sddmm_cuda(ug, vg))
    assert _same_bits(p, prev.gathered(U, V, i, j))
    scale = tref.sddmm_ref(ug.abs(), vg.abs())
    assert bool(((p - tref.sddmm_ref(ug, vg)).abs()
                 <= SDDMM_TOL["atol"] + SDDMM_TOL["rtol"] * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("K,runs", [(128, 64), (33, (1, 70)), (130, 5),
                                    (4, None)])
def test_gathered_sddmm_reads_zero_rows_out_of_range(cuda, K, runs):
    """Indices below 0 or past a factor's rows, alone and in whole runs
    (on either side), give the entry 0.0f, as the first design did;
    the other entries keep their bits."""
    prev = _first_design("sddmm_v1")
    E, n_u, n_v = 4000, 1000, 300
    U, V, i, j = tops.gathered_sddmm_probe(E, K, n_u, n_v, runs, cuda)
    g = torch.Generator().manual_seed(1)
    bad_i = torch.rand(E, generator=g) < 0.1
    bad_j = torch.rand(E, generator=g) < 0.1
    i = torch.where(bad_i.to(cuda), torch.where(i % 2 == 0, -1 - i, n_u + i),
                    i).int()
    i[1000:1200] = n_u      # a whole run out of range
    i[2000:2100] = -7
    j = torch.where(bad_j.to(cuda), n_v + j, j).int()
    p = tops.gathered_sddmm(U, V, i, j)
    torch.cuda.synchronize()
    out = (i < 0) | (i >= n_u) | (j < 0) | (j >= n_v)
    assert bool(out[1000:1200].all()) and bool(out[2000:2100].all())
    assert torch.equal(p[out], torch.zeros_like(p[out]))
    assert not bool(torch.signbit(p[out]).any())
    keep = ~out
    two_step = tsddmm.sddmm_cuda(U.index_select(0, i[keep]),
                                 V.index_select(0, j[keep]))
    assert _same_bits(p[keep], two_step)
    assert _same_bits(p, prev.gathered(U, V, i, j))


@pytest.mark.cuda
@pytest.mark.parametrize("R,T,K,n", [
    (3000, 1, 128, 500), (2048, 64, 128, 8192), (300, 1144, 128, 20_000),
    (131, 70, 33, 100), (8192, 0, 128, 5)])
def test_gathered_sddmm_padded_is_the_gathered_entry_bitwise(cuda, R, T, K,
                                                             n):
    """``ops.gathered_sddmm_padded(u, fixed, idx)``: row r of u against
    the T slots of idx[r], counted under ``sddmm_gathered``; bitwise the
    gathered entry, the pipeline and the first design over the vector
    of slot rows, and its plain version at SDDMM_TOL; an idx out of
    range reads a zero row."""
    prev = _first_design("sddmm_v1")
    g = torch.Generator().manual_seed(R + T)
    u = torch.randn(R, K, generator=g).to(cuda)
    fixed = torch.randn(n, K, generator=g).to(cuda)
    idx = torch.randint(0, n, (R, T), generator=g, dtype=torch.int32)
    idx[::7, ::3] = n + 5
    idx = idx.to(cuda)
    before = tsddmm.launches["sddmm_gathered"]
    p = tops.gathered_sddmm_padded(u, fixed, idx)
    torch.cuda.synchronize()
    assert tsddmm.launches["sddmm_gathered"] == before + 1
    assert p.shape == (R, T)
    rows, flat = tref.slot_rows(R, T, cuda), idx.reshape(-1)
    assert _same_bits(p.reshape(-1), tops.gathered_sddmm(u, fixed, rows,
                                                         flat))
    assert _same_bits(p.reshape(-1), prev.gathered(u, fixed, rows, flat))
    bad = flat >= n
    assert torch.equal(p.reshape(-1)[bad], torch.zeros_like(flat[bad],
                                                            dtype=p.dtype))
    ok = ~bad
    assert _same_bits(p.reshape(-1)[ok], tsddmm.sddmm_cuda(
        u.index_select(0, rows[ok]), fixed.index_select(0, flat[ok])))
    safe = torch.where(idx >= n, 0, idx).int()
    want = tref.gathered_sddmm_padded_ref(u, fixed, safe)
    torch.testing.assert_close(p[idx < n], want[idx < n], **SDDMM_TOL)


@pytest.mark.cuda
def test_gathered_sddmm_padded_refuses_what_it_does_not_take(cuda):
    u, fixed, _, _ = _gathered_sddmm_inputs(10, 8, 4, 5, cuda)
    idx = torch.zeros(4, 3, dtype=torch.int32, device=cuda)
    off = torch.empty(4 * 8 + 1, device=cuda)[1:].view(4, 8)
    off.copy_(u)
    with pytest.raises(ValueError, match="16-byte"):
        tsddmm.sddmm_padded_cuda(off, fixed, idx)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tsddmm.sddmm_padded_cuda(u, fixed, idx.cpu())
    with pytest.raises(TypeError, match="float32"):
        tsddmm.sddmm_padded_cuda(u, fixed.double(), idx)
    # bf16 u against fp32 rows: no sweep makes it
    with pytest.raises(TypeError, match="float32 x bfloat16"):
        tsddmm.sddmm_padded_cuda(u.bfloat16(), fixed, idx)
    with pytest.raises(TypeError, match="int32"):
        tsddmm.sddmm_padded_cuda(u, fixed, idx.long())
    with pytest.raises(ValueError, match="differ in K"):
        tsddmm.sddmm_padded_cuda(u, fixed[:, :4].contiguous(), idx)
    with pytest.raises(ValueError, match="a row for each"):
        tsddmm.sddmm_padded_cuda(u, fixed, idx[:3])
    with pytest.raises(ValueError, match="2-d"):
        tsddmm.sddmm_padded_cuda(u, fixed, idx.reshape(-1))


@pytest.mark.cuda
def test_gathered_sddmm_refuses_what_it_does_not_take(cuda):
    """No quiet fallback: wrong device, dtype, index type, shapes or
    rows off a 16-byte boundary raise; an index out of range reads a
    zero row."""
    U, V, i, j = _gathered_sddmm_inputs(10, 8, 4, 5, cuda)
    off = torch.empty(4 * 8 + 1, device=cuda)[1:].view(4, 8)
    off.copy_(U)
    with pytest.raises(ValueError, match="16-byte"):
        tsddmm.sddmm_gathered_cuda(off, V, i, j)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tsddmm.sddmm_gathered_cuda(U.cpu(), V, i, j)
    with pytest.raises(TypeError, match="float32"):
        tsddmm.sddmm_gathered_cuda(U.bfloat16(), V, i, j)
    with pytest.raises(TypeError, match="float32"):
        tsddmm.sddmm_gathered_cuda(U, V.bfloat16(), i, j)
    with pytest.raises(TypeError, match="int32"):
        tsddmm.sddmm_gathered_cuda(U, V, i.long(), j)
    with pytest.raises(ValueError, match="differ in K"):
        tsddmm.sddmm_gathered_cuda(U, V[:, :4].contiguous(), i, j)
    with pytest.raises(ValueError, match="differ"):
        tsddmm.sddmm_gathered_cuda(U, V, i, j[:5])
    bad = i.clone()
    bad[::2] = 4
    p = tsddmm.sddmm_gathered_cuda(U, V, bad, j)
    torch.cuda.synchronize()
    want = tref.sddmm_ref(U.index_select(0, i), V.index_select(0, j))
    assert torch.equal(p[::2], torch.zeros_like(p[::2]))
    torch.testing.assert_close(p[1::2], want[1::2], **SDDMM_TOL)


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
    (8, 32, 8192, 128, 100, 0.01),
    # S*K above the old kernel's shared memory; k above 1,024 (radix
    # select); k = N; more users than a scoring block's group of 8; K
    # that TMA does not take (plain-load staging) and K below a box
    (2, 512, 3000, 128, 100, 0.0), (3, 8, 5000, 16, 2048, 0.3),
    (2, 3, 777, 36, 777, 0.2), (9, 4, 3000, 32, 100, 0.1),
    (11, 3, 1000, 7, 750, 0.0), (4, 2, 20000, 4, 1500, 0.05),
    (17, 2, 9000, 64, 9000, 0.0)])
def test_topk_kernel_matches_plain(cuda, B, S, N, K, k, excl_frac):
    us, v, excl = _t(*_topk_inputs(B, S, N, K, excl_frac=excl_frac),
                     device=cuda)
    before = ttopk.launches["topk_score"]
    got = tops.topk_score(us, v, k, exclude=excl)
    torch.cuda.synchronize()
    assert ttopk.launches["topk_score"] == before + 1
    tops.reset_launch_counts()
    want = tops.topk_score(us.cpu(), v.cpu(), k, exclude=excl.cpu())
    assert tops.launch_counts()["topk_score"] == 0
    tref.check_topk_score([x.cpu() for x in got], want, us.cpu(), v.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,N,K,k", [(8, 32, 8192, 128, 100),
                                       (8, 512, 3000, 128, 100),
                                       (10, 6, 4000, 20, 2000),
                                       (9, 5, 2000, 7, 50)])
def test_topk_kernel_batch_invariant_and_deterministic(cuda, B, S, N, K, k):
    """A batched call is the same bits as one call per user, whatever
    scoring tile and chunk size each picks, and as itself run again."""
    us, v, excl = _t(*_topk_inputs(B, S, N, K, excl_frac=0.01),
                     device=cuda)
    batched = tops.topk_score(us, v, k, exclude=excl)
    again = tops.topk_score(us, v, k, exclude=excl)
    for x, y in zip(batched, again):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    for b in range(B):
        one = tops.topk_score(us[b:b + 1], v, k, exclude=excl[b:b + 1])
        for x, y in zip(batched, one):
            assert torch.equal(x[b:b + 1].view(torch.int32),
                               y.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1000, 2500])
def test_topk_kernel_ties_go_to_the_lowest_id(cuda, k):
    """Duplicated item rows and +-0.0 means tie exactly; the lowest item
    id comes first, as in the plain version, on the chunk route
    (k <= 1,024) and the radix route."""
    us, v, _ = _topk_inputs(2, 4, 3000, 8)
    v[:, 2000:2600] = v[:, 100:700]          # duplicates of lower ids
    v[:, 1500:1510] = 0.0
    v[:, 1510:1520] = -0.0
    us_t, v_t = _t(us, v, device=cuda)
    ids, mean, _ = tops.topk_score(us_t, v_t, k)
    wids, _, _ = tops.topk_score(torch.from_numpy(us),
                                 torch.from_numpy(v), k)
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
    zeros = torch.zeros((1, 3000, 1), device=cuda)
    zeros[0, 1::2] = -0.0
    zids, _, _ = tops.topk_score(neg, zeros, 2000)
    assert zids.tolist() == [list(range(2000))]


@pytest.mark.cuda
def test_topk_kernel_refuses_what_it_does_not_take(cuda):
    us, v, excl = _t(*_topk_inputs(2, 4, 3000, 8), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ttopk.topk_score_cuda(us.bfloat16(), v, excl, 5)
    with pytest.raises(TypeError, match="bfloat16 x bfloat16"):
        ttopk.topk_score_cuda(us, v.bfloat16(), excl, 5)
    with pytest.raises(TypeError, match="excl"):
        ttopk.topk_score_cuda(us, v, excl.bfloat16(), 5)
    with pytest.raises(ValueError, match="not contiguous"):
        ttopk.topk_score_cuda(us.transpose(1, 2), v, excl, 5)
    with pytest.raises(ValueError, match=r"must be in \[1, N=3000\]"):
        ttopk.topk_score_cuda(us, v, excl, 3001)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        ttopk.topk_score_cuda(us.cpu(), v, excl, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1025, 3000])
def test_topk_kernel_answers_k_above_1024(cuda, k):
    """k = 1,025 and k = N, which the chunk route could not take, answer
    through the radix route and equal the plain version; one call is
    one count, whatever number of kernels it launches."""
    us, v, excl = _t(*_topk_inputs(3, 6, 3000, 24, excl_frac=0.05),
                     device=cuda)
    before = ttopk.launches["topk_score"]
    got = tops.topk_score(us, v, k, exclude=excl)
    torch.cuda.synchronize()
    assert ttopk.launches["topk_score"] == before + 1
    want = tops.topk_score(us.cpu(), v.cpu(), k, exclude=excl.cpu())
    tref.check_topk_score([x.cpu() for x in got], want, us.cpu(), v.cpu())
    assert ttopk.plan(3, 3000, k).route == "radix"


@pytest.mark.cuda
def test_topk_kernel_passes_run_apart(cuda):
    """``launch`` runs scoring and selection apart over one scratch, as
    chip_smoke.py times them, and gives the call's answer, uncounted."""
    us, v, excl = _t(*_topk_inputs(8, 16, 5000, 64, excl_frac=0.02),
                     device=cuda)
    want = ttopk.topk_score_cuda(us, v, excl, 100)
    before = ttopk.launches["topk_score"]
    bufs = ttopk.launch(us, v, excl, 100, passes=1)
    bufs[0].fill_(-7)
    ttopk.launch(us, v, excl, 100, passes=2, bufs=bufs)
    assert ttopk.launches["topk_score"] == before
    for x, y in zip(bufs[:3], want):
        assert torch.equal(x, y)


FLASH_CASES = [
    # (q shape, k/v shape, masking arguments)
    *[(q, kv, kw) for q, kv, _, kw in tops.KERNELS["flash"].values()],
    ((2, 130, 4, 16), (2, 257, 2, 16),
     dict(causal=True, window=96, q_offset=100)),
    ((1, 8, 2, 8), (1, 4, 1, 8), dict(causal=True, window=2, q_offset=3)),
    ((2, 80, 9, 64), (2, 80, 3, 64), dict(causal=True)),
    ((1, 300, 32, 128), (1, 300, 8, 128), dict(causal=True)),
    ((1, 64, 6, 40), (1, 192, 3, 40), dict(causal=True, q_offset=128)),
    ((3, 7, 4, 128), (3, 1, 1, 128), dict(causal=False)),
    ((1, 1, 4, 32), (1, 200, 2, 32), dict(causal=True, q_offset=199)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("q_shape,kv_shape,kw", FLASH_CASES,
                         ids=[f"{q}-{kv}-{kw}" for q, kv, kw in FLASH_CASES])
def test_flash_kernel_matches_plain(cuda, q_shape, kv_shape, kw, dtype):
    rng = np.random.default_rng(sum(q_shape) + sum(kv_shape))
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(cuda, dtype) for s in (q_shape, kv_shape, kv_shape))
    before = tflash.launches
    out = tops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tflash.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    tref.check_attention(out, q, k, v, **kw)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_projection_views(cuda):
    """q, k and v as views of one fused projection (B, S, H + 2 KVH, hd)
    read in place give the bits of contiguous copies."""
    qkv = torch.randn(2, 100, 8 + 2 + 2, 64, device=cuda,
                      dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    out = tops.flash_attention(q, k, v, causal=True)
    again = tops.flash_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True)
    assert torch.equal(out, again)
    tref.check_attention(out, q, k, v, causal=True)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.randn(1, 8, 4, 16, device=cuda)
    k = torch.randn(1, 8, 2, 16, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tflash.flash_cuda(q.half(), k.half(), k.half(), causal=True)
    with pytest.raises(TypeError, match="q is"):
        tflash.flash_cuda(q, k.bfloat16(), k.bfloat16(), causal=True)
    with pytest.raises(ValueError, match="multiple of 8"):
        tflash.flash_cuda(q[..., :12], k[..., :12], k[..., :12],
                          causal=True)
    wide = torch.randn(1, 8, 2, 200, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        tflash.flash_cuda(wide, wide, wide, causal=True)
    # v may be narrower or wider than q and k, but not above 128
    with pytest.raises(ValueError, match="v head width 136"):
        tflash.flash_cuda(q, k, torch.randn(1, 8, 2, 136, device=cuda),
                          causal=True)
    with pytest.raises(ValueError, match="do not fit"):
        tflash.flash_cuda(q, k, torch.randn(1, 9, 2, 16, device=cuda),
                          causal=True)
    with pytest.raises(ValueError, match="KVH"):
        tflash.flash_cuda(q[:, :, :3], k, k, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_cuda(q.transpose(2, 3)[..., :4, :],
                          k.transpose(2, 3)[..., :2, :],
                          k.transpose(2, 3)[..., :2, :], causal=True)


# two widths, q/k hd against v hdv (MLA: 192 against 128): (q shape,
# k shape, hdv, masking).  DeepSeek-V2-Lite's heads at a short prefill;
# ragged Sq and Sk (not multiples of 64) with H > KVH, an offset and a
# window; the smoke config's 24 / 16; a v wider than q and k; a q/k
# width between the instantiated ones (136, padded to 192); G = 8 with
# a window from an offset past the last key, so that the rows from
# position 30 on see no key
TWO_WIDTH_CASES = [
    ((1, 300, 16, 192), (1, 300, 16, 192), 128, dict(causal=True)),
    ((2, 130, 8, 192), (2, 257, 2, 192), 128,
     dict(causal=True, window=96, q_offset=100)),
    ((2, 77, 4, 192), (2, 333, 4, 192), 128,
     dict(causal=True, q_offset=256)),
    ((1, 90, 6, 192), (1, 70, 3, 192), 128, dict(causal=False)),
    ((2, 50, 4, 24), (2, 50, 4, 24), 16, dict(causal=True)),
    ((1, 64, 4, 64), (1, 100, 2, 64), 128, dict(causal=True, q_offset=36)),
    ((1, 65, 2, 136), (1, 65, 1, 136), 40, dict(causal=True)),
    ((1, 100, 16, 192), (1, 60, 2, 192), 128,
     dict(causal=True, window=20, q_offset=50)),
]
# the cases that flash_sm90.cu's 192/128 instance takes in bf16
MLA_CASES = [c for c in TWO_WIDTH_CASES if (c[0][3], c[2]) == (192, 128)]


def _two_width(q_shape, kv_shape, hdv, device, dtype, seed):
    rng = np.random.default_rng(seed)
    shapes = (q_shape, kv_shape, kv_shape[:3] + (hdv,))
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(device, dtype) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("q_shape,kv_shape,hdv,kw", TWO_WIDTH_CASES,
                         ids=[f"{q}-{kv}-v{hdv}-{kw}"
                              for q, kv, hdv, kw in TWO_WIDTH_CASES])
def test_flash_two_widths_match_plain(cuda, q_shape, kv_shape, hdv, kw,
                                      dtype):
    """A v of another width than q and k runs the kernel of its route
    (bf16 192/128 on flash_sm90.cu, the rest on flash.cu), out and lse
    held against the plain version."""
    q, k, v = _two_width(q_shape, kv_shape, hdv, cuda, dtype,
                         sum(q_shape) + hdv)
    want = "flash_sm90" if (dtype, q_shape[3], hdv) == \
        (torch.bfloat16, 192, 128) else "flash"
    before = dict(tflash.design_launches)
    out, lse = tops.flash_attention_fwd(q, k, v, **kw)
    again = tops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert {s: n - before[s] for s, n in tflash.design_launches.items()} \
        == {s: 2 * (s == want) for s in before}
    assert out.dtype == dtype and out.shape == q_shape[:3] + (hdv,)
    assert torch.equal(out, again)
    tref.check_attention(out, q, k, v, **kw, what="flash two widths")
    tref.check_lse(lse, q, k, v, **kw)


@pytest.mark.cuda
def test_flash_two_widths_read_strided_views(cuda):
    """MLA's prefill hands v as a view into one (B, S, H, nope + v)
    product: flash_sm90.cu's TMA reads it in place (256 bytes into the
    buffer, 512-byte head stride), with the bits of a contiguous copy."""
    kvd = torch.randn(2, 140, 8, 128 + 128, device=cuda,
                      dtype=torch.bfloat16)
    q, k = (torch.randn(2, 140, 8, 192, device=cuda, dtype=torch.bfloat16)
            for _ in range(2))
    v = kvd[..., 128:]
    before = tflash.design_launches["flash_sm90"]
    out = tops.flash_attention(q, k, v, causal=True)
    assert torch.equal(out, tops.flash_attention(q, k, v.contiguous(),
                                                 causal=True))
    assert tflash.design_launches["flash_sm90"] == before + 2
    tref.check_attention(out, q, k, v, causal=True)


def _bwd_two_width_params():
    """(case, dtype, source) of the two-width backward for every design
    that takes the case: flash_bwd.cu always, flash_bwd_sm90.cu for bf16
    at 192/128 (MLA's prefill)."""
    out = []
    for q_shape, kv_shape, hdv, kw in TWO_WIDTH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            sources = ["flash_bwd"]
            if tflash_bwd.design(dtype, q_shape[3], hdv) == "flash_bwd_sm90":
                sources.insert(0, "flash_bwd_sm90")
            out += [pytest.param(q_shape, kv_shape, hdv, kw, dtype, src,
                                 id=f"{q_shape}-{kv_shape}-v{hdv}-{kw}-"
                                 f"{str(dtype)[6:]}-{src}")
                    for src in sources]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("q_shape,kv_shape,hdv,kw,dtype,source",
                         _bwd_two_width_params())
def test_flash_bwd_two_widths_match_plain(cuda, q_shape, kv_shape, hdv, kw,
                                          dtype, source):
    """The backward with v and dout narrower (or wider) than q and k:
    each design that takes the case within the stated tolerance of the
    plain version, the routed one through ``ops.flash_attention_bwd``
    (counted), two calls the same bits, dv v's width; the Hopper design
    also against flash_bwd.cu at the same call."""
    q, k, v = _two_width(q_shape, kv_shape, hdv, cuda, dtype,
                         sum(q_shape) + hdv)
    g = torch.randn(q_shape[:3] + (hdv,), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(
                        sum(kv_shape))).to(dtype)
    out, lse = tops.flash_attention_fwd(q, k, v, **kw)
    routed = tflash_bwd.design(dtype, q_shape[3], hdv) == source
    before = tops.launch_counts()["flash_bwd"]
    by_source = dict(tflash_bwd.design_launches)

    def call():
        if routed:
            return tops.flash_attention_bwd(q, k, v, out, lse, g, **kw)
        return tflash_bwd.launch(source, q, k, v, out, lse, g, **kw)
    grads = call()
    torch.cuda.synchronize()
    assert tops.launch_counts()["flash_bwd"] == before + routed
    assert tflash_bwd.design_launches[source] == by_source[source] + routed
    assert [tuple(x.shape) for x in grads] == [q_shape, kv_shape,
                                               kv_shape[:3] + (hdv,)]
    assert [x.dtype for x in grads] == [dtype] * 3
    tref.check_attention_bwd(grads, q, k, v, out, lse, g, **kw, what=source)
    blind = torch.isinf(lse).transpose(1, 2)          # (B, Sq, H)
    assert (grads[0][blind] == 0).all()
    again = call()
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    if source == "flash_bwd_sm90":
        first = tflash_bwd.launch("flash_bwd", q, k, v, out, lse, g, **kw)
        mags = tref.attention_bwd_magnitude(q, k, v, out, lse, g, **kw)
        tref.check_bwd_close(grads, first, mags, dtype,
                             what="flash_bwd_sm90 against flash_bwd")


@pytest.mark.cuda
def test_flash_bwd_two_widths_take_mla_views(cuda):
    """MLA's prefill hands v as a view into the ``kv_b`` product: the
    backward takes contiguous copies, the bits of a contiguous v, dv v's
    width."""
    kvd = torch.randn(2, 140, 8, 128 + 128, device=cuda,
                      dtype=torch.bfloat16)
    q, k = (torch.randn(2, 140, 8, 192, device=cuda, dtype=torch.bfloat16)
            for _ in range(2))
    v = kvd[..., 128:]
    g = torch.randn(2, 140, 8, 128, device=cuda, dtype=torch.bfloat16)
    out, lse = tops.flash_attention_fwd(q, k, v, causal=True)
    before = tflash_bwd.design_launches["flash_bwd_sm90"]
    got = tops.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    want = tops.flash_attention_bwd(q, k, v.contiguous(), out, lse, g,
                                    causal=True)
    torch.cuda.synchronize()
    assert tflash_bwd.design_launches["flash_bwd_sm90"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    tref.check_attention_bwd(got, q, k, v, out, lse, g, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("hd,hdv", [(192, 200), (192, 136), (200, 128),
                                    (192, 20)])
def test_flash_bwd_refuses_widths_it_does_not_take(cuda, hd, hdv, dtype):
    """q/k above 192 or v above 128 (or not a multiple of 8) raises before
    any launch: no other design or plain gradient stands in."""
    q, k = (torch.randn(1, 16, 2, hd, device=cuda, dtype=dtype)
            for _ in range(2))
    v = torch.randn(1, 16, 2, hdv, device=cuda, dtype=dtype)
    out = torch.randn(1, 16, 2, hdv, device=cuda, dtype=dtype)
    lse = torch.zeros(1, 2, 16, device=cuda)
    before = dict(tflash_bwd.design_launches)
    with pytest.raises(ValueError, match="width"):
        tops.flash_attention_bwd(q, k, v, out, lse, out, causal=True)
    assert tflash_bwd.design_launches == before


@pytest.mark.cuda
def test_mla_model_trains_through_the_two_width_backward(cuda):
    """The deepseek smoke model (24/16 heads: flash_bwd.cu in bf16)
    trains on the card: ``loss_fn``'s backward launches the two-width
    backward once a layer, the forward once a layer plus once a stacked
    layer's recompute (remat); every gradient leaf is finite."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_model, loss_fn
    cfg = get_smoke("deepseek_v2_lite_16b")
    model = init_model(cfg, seed=0, device=cuda, train=True)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda,
                         generator=torch.Generator(device=cuda)
                         .manual_seed(0))
    tops.reset_launch_counts()
    loss, _ = loss_fn(model, cfg, {"tokens": toks, "labels": toks})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    torch.cuda.synchronize()
    n_stack = len(model.stack)
    assert tops.launch_counts()["flash_bwd"] == cfg.n_layers
    assert tflash_bwd.design_launches == {"flash_bwd_sm90": 0,
                                          "flash_bwd": cfg.n_layers}
    assert tops.launch_counts()["flash"] == cfg.n_layers + n_stack
    assert bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.cuda
def test_mla_model_runs_the_two_width_kernel(cuda):
    """The deepseek smoke model on the card in bf16: each forward
    launches the two-width kernel once a layer; decoding through the
    absorbed MLA caches launches none and gives finite logits."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import (forward, init_model, init_serve_cache,
                                    serve_step)
    cfg = get_smoke("deepseek_v2_lite_16b")
    model = init_model(cfg, seed=0, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), device=cuda,
                         generator=torch.Generator(device=cuda)
                         .manual_seed(0))
    tops.reset_launch_counts()
    par, aux = forward(model, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    assert tops.launch_counts()["flash"] == cfg.n_layers
    assert tflash.design_launches == {"flash_sm90": 0, "flash": cfg.n_layers}
    assert float(aux) > 0 and bool(torch.isfinite(par.float()).all())
    caches = init_serve_cache(model, cfg, 2, 32)
    assert set(caches["stack"][0]["mixer"]) == {"c_kv", "k_rope"}
    for t in range(24):
        lg, caches = serve_step(model, cfg, caches, toks[:, t:t + 1])
        assert bool(torch.isfinite(lg.float()).all())
    assert caches["pos"] == 24
    assert tops.launch_counts()["flash"] == cfg.n_layers


def _on_card(arch, cuda):
    """The arch's smoke model in fp32 from one seed, on the CPU and a
    copy on the card."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_model
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    model = init_model(cfg, seed=0, device="cpu")
    return cfg, model, copy.deepcopy(model).to(cuda)


def _same(got, want, what):
    """fp32 on the card against the CPU: the kernels' fp32 attention and
    cuBLAS sum in another order than the plain versions on the CPU."""
    np.testing.assert_allclose(got.detach().float().cpu().numpy(),
                               want.detach().float().numpy(), rtol=1e-4,
                               atol=1e-4, err_msg=what)


@pytest.mark.cuda
def test_whisper_model_on_the_card_matches_the_cpu(cuda):
    """The whisper smoke model in fp32 on the card against the same
    model on the CPU: ``forward`` (one flash launch an encoder layer,
    two a decoder layer: self and cross), ``encode`` ->
    ``init_serve_cache(enc_out=)`` -> 8 ``serve_step``s (encode launches
    one a layer, decode none), and ``loss_fn``'s gradient (one flash_bwd launch an
    attention call, no causal mask in the encoder and cross blocks)."""
    from repro_torch.models import (encode, forward, init_serve_cache,
                                    loss_fn, serve_step)
    cfg, cpu, card = _on_card("whisper_medium", cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    frames = torch.from_numpy(rng.normal(size=(2, cfg.encoder_frames,
                                               cfg.d_model))
                              .astype(np.float32))
    batch = {"tokens": toks, "enc_frames": frames}
    tops.reset_launch_counts()
    got, _ = forward(card, cfg, batch)
    torch.cuda.synchronize()
    n_attn = cfg.n_encoder_layers + 2 * cfg.n_layers
    assert tops.launch_counts()["flash"] == n_attn
    _same(got, forward(cpu, cfg, batch)[0], "whisper forward")
    caches = {m: init_serve_cache(m, cfg, 2, 8,
                                  enc_out=encode(m, cfg, frames))
              for m in (cpu, card)}
    for t in range(8):
        outs = []
        for m in (cpu, card):
            lg, caches[m] = serve_step(m, cfg, caches[m], toks[:, t:t + 1])
            outs.append(lg)
        _same(outs[1], outs[0], f"whisper decode step {t}")
    # encode's layers on the card; decode launches no kernel
    assert tops.launch_counts()["flash"] == n_attn + cfg.n_encoder_layers
    card.requires_grad_(True)
    cpu.requires_grad_(True)
    batch["labels"] = toks
    grads = []
    for m in (cpu, card):
        loss, _ = loss_fn(m, cfg, batch, remat=False)
        grads.append(dict(zip([n for n, _ in m.named_parameters()],
                              torch.autograd.grad(loss,
                                                  list(m.parameters())))))
    assert tops.launch_counts()["flash_bwd"] == n_attn
    for name, g in grads[0].items():
        _same(grads[1][name], g, name)


@pytest.mark.cuda
def test_internvl2_model_on_the_card_matches_the_cpu(cuda):
    """The internvl2 smoke model in fp32 on the card against the CPU,
    with patch embeddings prepended: ``forward`` (one flash launch a
    layer over patches and tokens) and ``generate`` text-only (the same
    tokens)."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import forward
    cfg, cpu, card = _on_card("internvl2_2b", cuda)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 12))
    batch = {"tokens": toks, "frontend": rng.normal(
        size=(2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)}
    tops.reset_launch_counts()
    got, _ = forward(card, cfg, batch)
    torch.cuda.synchronize()
    assert got.shape == (2, 12, cfg.vocab_size)
    assert tops.launch_counts()["flash"] == cfg.n_layers
    _same(got, forward(cpu, cfg, batch)[0], "internvl2 forward")
    assert np.array_equal(generate(cfg, card, toks[:, :6], max_new=4),
                          generate(cfg, cpu, toks[:, :6], max_new=4))


# bf16 cases at the Hopper design's head widths (64, 128) that cross its
# tiles of 128 folded rows and 128 keys
SM90_CASES = [
    # Sq*G = 300 rows, Sk = 100 keys: neither a multiple of 128
    ((2, 100, 6, 64), (2, 100, 2, 64), dict(causal=True)),
    # G = 1, Sk = 333 from an offset of 256
    ((1, 77, 4, 128), (1, 333, 4, 128), dict(causal=True, q_offset=256)),
    # smollm: 9 query heads on 3 kv heads, G = 3
    ((2, 200, 9, 64), (2, 200, 3, 64), dict(causal=True)),
    # whisper: 16 heads of 64, G = 1; causal decoder, non-causal encoder
    ((2, 150, 16, 64), (2, 150, 16, 64), dict(causal=True)),
    ((2, 150, 16, 64), (2, 190, 16, 64), dict(causal=False)),
    # q_offset plus a window at hd 128: tiles before the window skipped
    ((2, 130, 8, 128), (2, 500, 2, 128),
     dict(causal=True, window=200, q_offset=370)),
    ((1, 64, 8, 128), (1, 1000, 2, 128), dict(causal=False)),
    ((1, 1, 32, 128), (1, 259, 8, 128), dict(causal=True, q_offset=258)),
]
WIDE_CASES = [c for c in FLASH_CASES
              if tflash.design(torch.bfloat16, c[0][3]) == "flash_sm90"] \
    + SM90_CASES


def _bf16(shapes, device, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(device, torch.bfloat16) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["flash_sm90", "flash"])
@pytest.mark.parametrize("q_shape,kv_shape,kw", WIDE_CASES,
                         ids=[f"{q}-{kv}-{kw}" for q, kv, kw in WIDE_CASES])
def test_flash_designs_match_plain(cuda, q_shape, kv_shape, kw, source):
    """Both designs at bf16 hd 64/128: the one the wrapper routes there
    (flash_sm90) and the PR-14 kernel of flash.cu, launched directly."""
    q, k, v = _bf16((q_shape, kv_shape, kv_shape), cuda,
                    sum(q_shape) + sum(kv_shape))
    out = tflash.launch(source, q, k, v, **kw)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    tref.check_attention(out, q, k, v, **kw, what=source)


@pytest.mark.cuda
def test_flash_routes_by_dtype_and_head_width(cuda):
    """bf16 at hd 64 and 128 launches flash_sm90; fp32 at hd 128 and
    bf16 at hd 16 launch flash.cu's kernels; ``launches`` is the sum."""
    tops.reset_launch_counts()
    for dtype, hd, want in ((torch.bfloat16, 128, "flash_sm90"),
                            (torch.bfloat16, 64, "flash_sm90"),
                            (torch.float32, 128, "flash"),
                            (torch.bfloat16, 16, "flash")):
        q, k, v = (torch.randn(1, 40, 4, hd, device=cuda).to(dtype)
                   for _ in range(3))
        before = dict(tflash.design_launches)
        tops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert {s: n - before[s] for s, n in
                tflash.design_launches.items()} == \
            {s: int(s == want) for s in before}, (dtype, hd)
    assert tops.launch_counts()["flash"] == 4
    assert tflash.design_launches == {"flash_sm90": 2, "flash": 2}


@pytest.mark.cuda
def test_flash_sm90_reads_strided_projection_views(cuda):
    """At hd 128, q, k and v as views of one fused projection give the
    bits of contiguous copies (TMA reads k and v through their strides)."""
    qkv = torch.randn(2, 300, 8 + 2 + 2, 128, device=cuda,
                      dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    before = tflash.design_launches["flash_sm90"]
    out = tops.flash_attention(q, k, v, causal=True)
    again = tops.flash_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True)
    assert tflash.design_launches["flash_sm90"] == before + 2
    assert torch.equal(out, again)
    tref.check_attention(out, q, k, v, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", [
    ((2, 600, 32, 128), (2, 600, 8, 128), (2, 600, 8, 128)),
    ((2, 600, 16, 192), (2, 600, 16, 192), (2, 600, 16, 128))],
    ids=["hd128", "192/128"])
def test_flash_sm90_gives_the_same_bits_twice(cuda, shapes):
    q, k, v = _bf16(shapes, cuda, 7)
    before = tflash.design_launches["flash_sm90"]
    a = tops.flash_attention(q, k, v, causal=True)
    b = tops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tflash.design_launches["flash_sm90"] == before + 2
    assert torch.equal(a, b)
    tref.check_attention(a, q, k, v, causal=True, what="flash_sm90")


# the backward: its probes, then head widths 8 to 128 with a window from
# an offset (fully masked rows), non-causal G = 1 and causal G = 3
BWD_CASES = [(q, kv, kw) for q, kv, _, kw in
             tops.KERNELS["flash_bwd"].values()] + [
    ((2, 70, 6, hd), (2, 90, 2, hd), dict(causal=True, window=33,
                                          q_offset=25))
    for hd in (8, 16, 40, 64, 120, 128)] + [
    ((1, 8, 2, 64), (1, 4, 1, 64), dict(causal=True, window=2, q_offset=3)),
    ((2, 50, 3, 32), (2, 77, 3, 32), dict(causal=False)),
    ((1, 300, 9, 64), (1, 300, 3, 64), dict(causal=True)),
    ((1, 130, 32, 128), (1, 130, 8, 128), dict(causal=True))]


def _bwd_inputs(q_shape, kv_shape, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(device, dtype)
            for s in (q_shape, kv_shape, kv_shape, q_shape)]


# bf16 cases at the Hopper backward's head widths (64, 128) that cross
# its tiles (128 keys and 64 positions in dK/dV, 128 positions and 64 or
# 128 keys in dQ): Sq and Sk that are not multiples of 64 or 128, GQA
# groups of 1, 3 and 4, windows from an offset (rows that see no key),
# not causal
BWD_SM90_CASES = [
    ((2, 100, 6, 64), (2, 100, 2, 64), dict(causal=True)),
    ((2, 257, 8, 64), (2, 257, 2, 64), dict(causal=True)),
    ((1, 77, 4, 128), (1, 333, 4, 128), dict(causal=True, q_offset=256)),
    ((2, 130, 8, 128), (2, 500, 2, 128),
     dict(causal=True, window=200, q_offset=370)),
    ((3, 70, 6, 128), (3, 90, 2, 128),
     dict(causal=True, window=33, q_offset=25)),
    ((1, 24, 4, 64), (1, 20, 2, 64), dict(causal=True, window=3,
                                          q_offset=19)),
    ((1, 64, 8, 128), (1, 1000, 2, 128), dict(causal=False)),
    ((2, 150, 16, 64), (2, 190, 16, 64), dict(causal=False))]


def _bwd_params(cases):
    """(case, dtype, source) for every design that takes the case:
    flash_bwd.cu always, flash_bwd_sm90.cu for bf16 at hd 64 and 128."""
    out = []
    for q_shape, kv_shape, kw in cases:
        for dtype in (torch.float32, torch.bfloat16):
            sources = ["flash_bwd"]
            if tflash_bwd.design(dtype, q_shape[3]) == "flash_bwd_sm90":
                sources.insert(0, "flash_bwd_sm90")
            out += [pytest.param(q_shape, kv_shape, kw, dtype, src,
                                 id=f"{q_shape}-{kv_shape}-{kw}-"
                                 f"{str(dtype)[6:]}-{src}")
                    for src in sources]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("q_shape,kv_shape,kw,dtype,source",
                         _bwd_params(BWD_CASES + BWD_SM90_CASES))
def test_flash_bwd_kernel_matches_plain(cuda, q_shape, kv_shape, kw, dtype,
                                        source):
    """Each design that takes a case, within the stated tolerance of the
    plain version: the one ``design`` routes to through
    ``ops.flash_attention_bwd`` (counted, on that design), the other
    launched directly; dq is 0 where a row sees no key; no
    floating-point atomics: a second call gives the same bits."""
    q, k, v, g = _bwd_inputs(q_shape, kv_shape, dtype, cuda,
                             sum(q_shape) + sum(kv_shape))
    out, lse = tops.flash_attention_fwd(q, k, v, **kw)
    routed = tflash_bwd.design(dtype, q_shape[3]) == source
    before = tops.launch_counts()["flash_bwd"]
    by_source = dict(tflash_bwd.design_launches)

    def call():
        if routed:
            return tops.flash_attention_bwd(q, k, v, out, lse, g, **kw)
        return tflash_bwd.launch(source, q, k, v, out, lse, g, **kw)
    grads = call()
    torch.cuda.synchronize()
    assert tops.launch_counts()["flash_bwd"] == before + routed
    assert tflash_bwd.design_launches[source] == by_source[source] + routed
    assert [x.dtype for x in grads] == [dtype] * 3
    tref.check_attention_bwd(grads, q, k, v, out, lse, g, **kw, what=source)
    blind = torch.isinf(lse).transpose(1, 2)          # (B, Sq, H)
    assert (grads[0][blind] == 0).all()
    again = call()
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.cuda
@pytest.mark.parametrize("q_shape,kv_shape,kw", BWD_SM90_CASES,
                         ids=[f"{q}-{kv}-{kw}" for q, kv, kw in
                              BWD_SM90_CASES])
def test_flash_bwd_sm90_matches_the_first_design(cuda, q_shape, kv_shape,
                                                 kw):
    """The Hopper design against the first bf16 design
    (``csrc/flash_bwd.cu``, the mma.sync kernels) within
    ``FLASH_BWD_RTOL`` of |first| + the terms' magnitudes: the sums run
    in another order, so the bits differ."""
    q, k, v, g = _bwd_inputs(q_shape, kv_shape, torch.bfloat16, cuda, 3)
    out, lse = tops.flash_attention_fwd(q, k, v, **kw)
    got = tflash_bwd.launch("flash_bwd_sm90", q, k, v, out, lse, g, **kw)
    want = tflash_bwd.launch("flash_bwd", q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    mags = tref.attention_bwd_magnitude(q, k, v, out, lse, g, **kw)
    tref.check_bwd_close(got, want, mags, torch.bfloat16,
                         what="flash_bwd_sm90 against flash_bwd")


@pytest.mark.cuda
def test_flash_bwd_routes_by_dtype_and_head_width(cuda):
    """bf16 at hd 64 and 128 launches flash_bwd_sm90; fp32 at hd 64 and
    bf16 at hd 32 launch flash_bwd.cu's kernels; ``launches`` is the
    sum."""
    tops.reset_launch_counts()
    for dtype, hd, want in ((torch.bfloat16, 128, "flash_bwd_sm90"),
                            (torch.bfloat16, 64, "flash_bwd_sm90"),
                            (torch.float32, 64, "flash_bwd"),
                            (torch.bfloat16, 32, "flash_bwd")):
        q, k, v, g = _bwd_inputs((1, 40, 4, hd), (1, 40, 2, hd), dtype,
                                 cuda, hd)
        out, lse = tops.flash_attention_fwd(q, k, v, causal=True)
        before = dict(tflash_bwd.design_launches)
        tops.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
        torch.cuda.synchronize()
        assert {s: n - before[s] for s, n in
                tflash_bwd.design_launches.items()} == \
            {s: int(s == want) for s in before}, (dtype, hd)
    assert tops.launch_counts()["flash_bwd"] == 4
    assert tflash_bwd.design_launches == {"flash_bwd_sm90": 2,
                                          "flash_bwd": 2}


# (q shape, k shape, v width, masking): one width at hd 64 and 128, and
# MLA's 192/128, which both designs take in bf16
LSE_CASES = [(q, kv, kv[3], kw) for q, kv, kw in WIDE_CASES[:6]] \
    + MLA_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["flash_sm90", "flash"])
@pytest.mark.parametrize("q_shape,kv_shape,hdv,kw", LSE_CASES,
                         ids=[f"{q}-{kv}-v{hdv}-{kw}" for q, kv, hdv, kw in
                              LSE_CASES])
def test_lse_forward_keeps_the_output_bits(cuda, q_shape, kv_shape, hdv, kw,
                                           source):
    """Both designs: out with the lse output is the bits of out without
    it, out and lse the plain version's."""
    q, k, v = _bf16((q_shape, kv_shape, kv_shape[:3] + (hdv,)), cuda,
                    sum(q_shape) + sum(kv_shape))
    lse = torch.full((q_shape[0], q_shape[2], q_shape[1]), torch.nan,
                     device=cuda)
    out = tflash.launch(source, q, k, v, **kw, lse=lse)
    plain = tflash.launch(source, q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    tref.check_attention(out, q, k, v, **kw, what=source)
    tref.check_lse(lse, q, k, v, **kw, what=source)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,hdv", [(64, 64), (192, 128)])
def test_lse_of_a_call_with_no_key_is_inf(cuda, hd, hdv):
    """Sk = 0 on the Hopper design: out is all zeros and v's width wide
    (its memset sizes out by hdv), every lse +inf."""
    q = torch.randn(1, 5, 4, hd, device=cuda, dtype=torch.bfloat16)
    k = torch.randn(1, 0, 2, hd, device=cuda, dtype=torch.bfloat16)
    v = torch.randn(1, 0, 2, hdv, device=cuda, dtype=torch.bfloat16)
    before = tflash.design_launches["flash_sm90"]
    out, lse = tflash.flash_cuda(q, k, v, causal=False, return_lse=True)
    torch.cuda.synchronize()
    assert tflash.design_launches["flash_sm90"] == before + 1
    assert out.shape == (1, 5, 4, hdv) and (out == 0).all()
    assert torch.isinf(lse).all() and (lse > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_attention_fn_gradient_matches_autograd_of_the_plain_version(
        cuda, dtype):
    """The layers' autograd Function on the card (flash forward with lse,
    flash_bwd backward) against torch.autograd through
    ``ref.attention_ref`` on the same inputs, within the backward's
    stated tolerance; a strided dout is taken."""
    from repro_torch.models import layers as tL
    q, k, v, g = _bwd_inputs((2, 150, 9, 64), (2, 150, 3, 64), dtype, cuda,
                             11)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tL.attention_fn(*leaves, causal=True)
    gt = g.transpose(1, 2).contiguous().transpose(1, 2)      # strided
    got = torch.autograd.grad(out, leaves, gt)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(tref.attention_ref(*plain, causal=True),
                               plain, g)
    _, lse = tref.attention_ref(q, k, v, causal=True, return_lse=True)
    rtol = tref.FLASH_BWD_RTOL[dtype]
    mags = tref.attention_bwd_magnitude(q, k, v, out.detach(), lse, g,
                                        causal=True)
    for a, b, m in zip(got, want, mags):
        assert a.dtype == dtype
        diff = (a.float() - b.float()).abs()
        assert (diff <= rtol * (b.float().abs() + m)).all(), \
            diff.max().item()


@pytest.mark.cuda
def test_flash_bwd_refuses_what_it_does_not_take(cuda):
    q, k, v, g = _bwd_inputs((1, 8, 4, 16), (1, 8, 2, 16), torch.float32,
                             cuda, 0)
    out, lse = tops.flash_attention_fwd(q, k, v, causal=True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tflash_bwd.flash_bwd_cuda(q.half(), k.half(), v.half(), out.half(),
                                  lse, g.half(), causal=True)
    with pytest.raises(TypeError, match="lse"):
        tflash_bwd.flash_bwd_cuda(q, k, v, out, lse.double(), g,
                                  causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        tflash_bwd.flash_bwd_cuda(q, k, v, out, lse,
                                  g.transpose(1, 2).contiguous()
                                  .transpose(1, 2), causal=True)
    with pytest.raises(ValueError, match="KVH"):
        tflash_bwd.flash_bwd_cuda(q[:, :, :3].contiguous(), k, v,
                                  out[:, :, :3].contiguous(), lse[:, :3]
                                  .contiguous(), g[:, :, :3].contiguous(),
                                  causal=True)
    # the Hopper route (bf16, hd 64): an operand off a 16-byte boundary
    # or not contiguous is refused before any launch
    q, k, v, g = _bwd_inputs((1, 8, 4, 64), (1, 8, 2, 64), torch.bfloat16,
                             cuda, 0)
    out, lse = tops.flash_attention_fwd(q, k, v, causal=True)
    assert tflash_bwd.design(q.dtype, 64) == "flash_bwd_sm90"
    before = dict(tflash_bwd.design_launches)
    shifted = torch.empty(q.numel() + 1, device=cuda,
                          dtype=torch.bfloat16)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        tflash_bwd.flash_bwd_cuda(shifted, k, v, out, lse, g, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        tflash_bwd.flash_bwd_cuda(q, k.transpose(1, 2).contiguous()
                                  .transpose(1, 2), v, out, lse, g,
                                  causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        tflash_bwd.flash_bwd_cuda(q, k, v, out, lse,
                                  g.transpose(1, 2).contiguous()
                                  .transpose(1, 2), causal=True)
    assert tflash_bwd.design_launches == before


# ---------------------------------------------------------------------------
# the bf16 entries of the bf16_gather sweep
# ---------------------------------------------------------------------------

# (R, T, K, n_fixed, empty rows): K = 9 (element-wise row loads), 32, 33,
# 128 (the sweep's width) and 256 (the tiled path)
GRAM_BF16_CASES = [(3, 5, 9, 4, 1), (16, 130, 32, 40, 2),
                   (13, 257, 33, 50, 3), (300, 70, 128, 1000, 5),
                   (4, 40, 256, 30, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,T,K,n_fixed,empty", GRAM_BF16_CASES)
def test_gathered_gram_bf16_matches_plain_and_its_pipeline(
        cuda, R, T, K, n_fixed, empty):
    """``gram_gathered_bf16`` (a bf16 fixed factor): two blocks' order,
    the second with acc and a Lambda_p that is not symmetric, against
    ``ref.gathered_gram_ref``'s bf16 program at GRAM_TOL, counted under
    ``gram_gathered_bf16`` (the fp32 count does not move); with
    alpha 1 and neither acc nor lam, bitwise ``gram_bf16`` on the
    ``index_select``ed slab, the pipeline it replaces."""
    f1, i1, v1, m1 = _gathered_inputs(R, T, K, n_fixed, empty, cuda, 0)
    f2, i2, v2, m2 = _gathered_inputs(R, T + 3, K, n_fixed, 0, cuda, 1)
    f1, f2 = f1.bfloat16(), f2.bfloat16()
    a1 = torch.tensor(1.7, device=cuda)
    a2 = torch.tensor(0.45, device=cuda)
    lam = torch.randn(K, K, device=cuda)
    before, fp32 = tgram.launches["gram_gathered_bf16"], tgram.launches["gram"]
    acc = tops.gathered_gram_and_rhs(f1, i1, v1, m1, a1)
    g, r = tops.gathered_gram_and_rhs(f2, i2, v2, m2, a2, acc=acc, lam=lam)
    torch.cuda.synchronize()
    n = 1 if K <= tgram.TILE else 2
    assert tgram.launches["gram_gathered_bf16"] == before + 2 * n
    assert tgram.launches["gram"] == fp32
    w1 = tref.gathered_gram_ref(f1.cpu(), i1.cpu(), v1.cpu(), m1.cpu(),
                                a1.cpu())
    gw, rw = tref.gathered_gram_ref(f2.cpu(), i2.cpu(), v2.cpu(), m2.cpu(),
                                    a2.cpu(), acc=w1, lam=lam.cpu())
    torch.testing.assert_close(g.cpu(), gw, **GRAM_TOL)
    torch.testing.assert_close(r.cpu(), rw, **GRAM_TOL)
    one = torch.tensor(1.0, device=cuda)
    got = tgram.gathered_gram_cuda(f1, i1, v1, m1, one)
    vg = f1.index_select(0, i1.reshape(-1)).reshape(R, T, K)
    want = tgram.gram_cuda(vg, v1, m1)
    assert all(_same_bits(a, b) for a, b in zip(got, want))


# (E, K, n_u, n_v, runs): the sddmm_gathered probes and ragged cases
SDDMM_BF16_CASES = [*tops.KERNELS["sddmm_gathered"].values(),
                    (0, 128, 5, 5, None), (1, 1, 1, 1, None),
                    (3000, 33, 7, 3000, None), (2049, 130, 50, 40, None),
                    (3000, 520, 200, 50, (1, 70)),
                    (64 * 129, 128, 129, 8192, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("E,K,n_u,n_v,runs", SDDMM_BF16_CASES)
def test_gathered_sddmm_bf16_is_its_pipelines_bits(cuda, E, K, n_u, n_v,
                                                   runs):
    """``sddmm_gathered_bf16`` (U and V bf16): bitwise ``sddmm_bf16`` on
    the ``index_select``ed rows (the pipeline it replaces) and the fp32
    gathered entry on the widened factors, within SDDMM_TOL of its
    plain version, counted under ``sddmm_gathered_bf16``."""
    U, V, i, j = (x.to(cuda) for x in tops.gathered_sddmm_probe(
        E, K, n_u, n_v, runs, "cpu", seed=E + K))
    U, V = U.bfloat16(), V.bfloat16()
    before, fp32 = tsddmm.launches["sddmm_gathered_bf16"], tsddmm.launches["sddmm_gathered"]
    p = tops.gathered_sddmm(U, V, i, j)
    torch.cuda.synchronize()
    assert tsddmm.launches["sddmm_gathered_bf16"] == before + 1
    assert tsddmm.launches["sddmm_gathered"] == fp32
    assert _same_bits(p, tsddmm.sddmm_cuda(U.index_select(0, i),
                                           V.index_select(0, j)))
    assert _same_bits(p, tsddmm.sddmm_gathered_cuda(U.float(), V.float(),
                                                    i, j))
    torch.testing.assert_close(p, tref.gathered_sddmm_ref(U, V, i, j),
                               **SDDMM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16],
                         ids=["mixed", "bf16"])
@pytest.mark.parametrize("R,T,K,n", [
    (3000, 1, 128, 500), (2048, 64, 128, 8192), (131, 70, 33, 100),
    (8192, 0, 128, 5), (50, 9, 6, 40)])
def test_gathered_sddmm_padded_bf16_entries(cuda, u_dtype, R, T, K, n):
    """The padded entry on bf16 fixed rows, with fp32 u
    (``sddmm_padded_mixed``: probit's predictions in the bf16 sweep) or
    bf16 u (``sddmm_padded_bf16``: the distributed sweep's residuals):
    bitwise the fp32 padded entry on the widened operands, within
    SDDMM_TOL of the plain version, each counted under its own count;
    an idx out of range reads a zero row."""
    g = torch.Generator().manual_seed(R + T)
    u = torch.randn(R, K, generator=g).to(cuda, u_dtype)
    fixed = torch.randn(n, K, generator=g).to(cuda, torch.bfloat16)
    idx = torch.randint(0, n, (R, T), generator=g, dtype=torch.int32)
    idx[::7, ::3] = n + 5
    idx = idx.to(cuda)
    mixed = u_dtype == torch.float32
    counts = tops.launch_counts()
    p = tops.gathered_sddmm_padded(u, fixed, idx)
    torch.cuda.synchronize()
    key = "sddmm_padded_mixed" if mixed else "sddmm_padded_bf16"
    after = tops.launch_counts()
    assert after[key] == counts[key] + 1
    assert after["sddmm_gathered"] == counts["sddmm_gathered"]
    assert p.shape == (R, T) and p.dtype == torch.float32
    assert _same_bits(p, tops.gathered_sddmm_padded(u.float(),
                                                    fixed.float(), idx))
    ok = idx < n
    safe = torch.where(ok, idx, 0).int()
    want = tref.gathered_sddmm_padded_ref(u, fixed, safe)
    torch.testing.assert_close(p[ok], want[ok], **SDDMM_TOL)
    assert torch.equal(p[~ok], torch.zeros_like(p[~ok]))


# (B, S, N, K, k, excl): the topk probes in bf16, K that TMA takes in bf16
# (K % 8 == 0) and that it does not (plain-load staging: 4, 12, 36), k
# above 1,024 (radix select), more users than a group of 8
TOPK_BF16_CASES = [
    *[(us[0], us[1], v[1], us[2], k, 0.0) for us, v, k
      in tops.KERNELS["topk_score_bf16"].values()],
    (8, 32, 8192, 128, 100, 0.01), (2, 512, 3000, 128, 100, 0.0),
    (3, 8, 5000, 16, 2048, 0.3), (2, 3, 777, 36, 777, 0.2),
    (9, 4, 3000, 12, 100, 0.1), (11, 3, 1000, 4, 750, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,N,K,k,excl_frac", TOPK_BF16_CASES)
def test_topk_bf16_matches_plain_and_the_fp32_kernel(cuda, B, S, N, K, k,
                                                     excl_frac):
    """``topk_score_bf16``: held against the plain version's bf16
    branch by ``ref.check_topk_score``; bitwise the fp32 kernel on the
    widened operands (the same fmaf chain over the same k order, the
    bf16 map's 64-byte rows and swizzle or the plain-load staging
    feeding it); a batched call bitwise B single-user calls; counted
    under ``topk_score_bf16``."""
    us, v, excl = _t(*_topk_inputs(B, S, N, K, excl_frac=excl_frac),
                     device=cuda)
    us, v = us.bfloat16(), v.bfloat16()
    before, fp32 = ttopk.launches["topk_score_bf16"], ttopk.launches["topk_score"]
    got = tops.topk_score(us, v, k, exclude=excl)
    torch.cuda.synchronize()
    assert ttopk.launches["topk_score_bf16"] == before + 1 and ttopk.launches["topk_score"] == fp32
    want = tops.topk_score(us.cpu(), v.cpu(), k, exclude=excl.cpu())
    tref.check_topk_score([x.cpu() for x in got], want, us.cpu().float(),
                          v.cpu().float())
    wide = tops.topk_score(us.float(), v.float(), k, exclude=excl)
    for x, y in zip(got, wide):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    for b in range(min(B, 3)):
        one = tops.topk_score(us[b:b + 1], v, k, exclude=excl[b:b + 1])
        for x, y in zip(got, one):
            assert torch.equal(x[b:b + 1].view(torch.int32),
                               y.view(torch.int32))


def _state_to(st, device):
    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(move(v) for v in x)
        return x.to(device) if isinstance(x, torch.Tensor) else x
    return type(st)(*(move(x) for x in st))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gaussian", "gaussian_fixed", "probit",
                                  "macau", "dense_full", "dense_masked",
                                  "gfa"])
def test_bf16_gather_sweep_of_each_model_kind(cuda, name, monkeypatch):
    """``ModelBuilder(bf16_gather=True)`` on the card for every model
    kind (``test_torch_bf16_gather.build``): one sweep from the CPU's
    initial state.  Every factor and metric finite, the first entity's
    update against the CPU plain path's within 2e-4 (the same bf16
    copies; the card's kernels, Cholesky and solves sum in other
    orders), and the launches on the bf16 entries alone: gram's and the
    gathered sddmm's a sparse block, probit's mixed padded entry, none
    of the fp32 gathered entries.  Probit's latents differ between the
    card and the CPU by ULPs even on the same predictions (``erf_inv``'s
    ``log1p`` and ``sqrt``), and the card's own latents carried its
    update past 2e-4; so under probit the card's update is fed the
    CPU's latents, call by call, and held from there, while the first
    call's predictions (the mixed padded entry's, or the dense block's
    product) are held against the CPU's, and the card's own latents on
    the CPU's predictions are printed beside the CPU's (``-s``)."""
    from test_torch_bf16_gather import build
    from repro_torch import core as tc
    from repro_torch.core import noise as tnoise
    cm, cd = build(tc, name, device="cpu")
    gm, gd = build(tc, name, device=cuda)
    st = tc.init_state(cm, cd, seed=0)
    real = tnoise.ProbitNoise.augment
    seen = []       # the CPU's (pred, latents), in call order

    def record(self, key, state, pred, vals, mask, row_offset=0):
        out = real(self, key, state, pred, vals, mask, row_offset)
        seen.append((pred, out[0]))
        return out

    monkeypatch.setattr(tnoise.ProbitNoise, "augment", record)
    want, _ = tc.gibbs_step(cm, cd, st)
    fed = []

    def replay(self, key, state, pred, vals, mask, row_offset=0):
        cpu_pred, cpu_z = seen[len(fed)]
        own = real(self, key, state, cpu_pred.to(cuda), vals, mask,
                   row_offset)[0]
        fed.append((pred, cpu_pred, own, cpu_z))
        return cpu_z.to(cuda), state["alpha"]

    monkeypatch.setattr(tnoise.ProbitNoise, "augment", replay)
    tops.reset_launch_counts()
    got, metrics = tc.gibbs_step(gm, gd, _state_to(st, cuda))
    torch.cuda.synchronize()
    counts = tops.launch_counts()
    assert len(fed) == len(seen)
    if fed:
        pred, cpu_pred, own, cpu_z = fed[0]
        torch.testing.assert_close(pred.cpu(), cpu_pred, rtol=1e-5,
                                   atol=1e-4)
        diff = (own.cpu() - cpu_z).abs()
        print(f"\n{name}: the card's latents on the CPU's predictions "
              f"against the CPU's: {int((diff > 0).sum())} of "
              f"{diff.numel()} differ, max |diff| {float(diff.max()):.3e}"
              f"; predictions max |diff| "
              f"{float((pred.cpu() - cpu_pred).abs().max()):.3e}")
        assert bool(torch.isfinite(own).all())
    torch.testing.assert_close(got.factors[0].cpu(), want.factors[0],
                               rtol=2e-4, atol=2e-4)
    assert all(bool(torch.isfinite(f).all()) for f in got.factors)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    sparse = sum(b.sparse for b in gm.blocks)
    halves = sum(len([1 for b in gm.blocks if b.sparse and e in
                      (b.row_entity, b.col_entity)])
                 for e in range(len(gm.entities))
                 if type(gm.entities[e].prior).__name__
                 != "SpikeAndSlabPrior")
    probit = 2 * sum(b.sparse and type(b.noise).__name__ == "ProbitNoise"
                     for b in gm.blocks)
    assert counts["gram_gathered_bf16"] == halves
    assert counts["sddmm_gathered_bf16"] == sparse
    assert counts["sddmm_padded_mixed"] == probit
    assert counts["gram"] == counts["sddmm_gathered"] == 0
