"""The port's kernels against the JAX package's.

On the CPU the dispatch in ``repro_torch.kernels.ops`` runs the plain
versions of ``ref.py``; those are held against ``repro``'s jnp oracles
and against the Pallas kernels in interpret mode.  The CUDA kernels themselves
need the card: ``test_torch_kernels_cuda.py`` holds them against the
plain versions, and ``chip_smoke.py`` does so at the main path's
shapes.

Tolerance rtol 1e-5 / atol 1e-4 (gram) and 1e-5 (sddmm): fp32 on both
sides, summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import gram as tgram
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sddmm as tsddmm
from torch_threads import _one_thread  # noqa: F401 (autouse)

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


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("R,T,K", [(1, 1, 1), (3, 5, 7), (16, 40, 8),
                                   (13, 257, 33)])
def test_gram_plain_matches_jax_oracle_and_pallas(R, T, K):
    vg, val, mask = _gram_inputs(R, T, K)
    g, r = tops.gram_and_rhs(*_t(vg, val, mask))
    jg, jr = jref.gram_ref(jnp.asarray(vg), jnp.asarray(val),
                           jnp.asarray(mask))
    pg, pr = jops.gram_and_rhs(jnp.asarray(vg), jnp.asarray(val),
                               jnp.asarray(mask), use_pallas=True,
                               interpret=True)
    for want_g, want_r in ((jg, jr), (pg, pr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g),
                                   **GRAM_TOL)
        np.testing.assert_allclose(r.numpy(), np.asarray(want_r),
                                   **GRAM_TOL)


@pytest.mark.parametrize("E,K", [(1, 3), (100, 16), (1025, 200)])
def test_sddmm_plain_matches_jax_oracle_and_pallas(E, K):
    u, v = _sddmm_inputs(E, K)
    got = tops.sddmm(*_t(u, v)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jref.sddmm_ref(jnp.asarray(u), jnp.asarray(v))),
        **SDDMM_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jops.sddmm(jnp.asarray(u), jnp.asarray(v),
                                   use_pallas=True, interpret=True)),
        **SDDMM_TOL)


def test_cpu_dispatch_launches_no_kernel():
    tops.reset_launch_counts()
    tops.gram_and_rhs(*_t(*_gram_inputs(2, 3, 4)))
    tops.sddmm(*_t(*_sddmm_inputs(5, 4)))
    tops.gathered_sddmm(*_t(*_sddmm_inputs(5, 4)),
                        *_t(np.array([0, 4, 2], np.int32),
                            np.array([1, 1, 3], np.int32)))
    tops.gathered_sddmm_padded(*_t(*_sddmm_inputs(5, 4)),
                               *_t(np.array([[0, 4], [2, 2], [1, 3],
                                             [0, 0], [4, 1]], np.int32)))
    # the bf16 operands of the bf16_gather sweep take the plain version
    # on the CPU too
    u, v = (x.bfloat16() for x in _t(*_sddmm_inputs(5, 4)))
    i, j = _t(np.array([0, 4, 2], np.int32), np.array([1, 1, 3], np.int32))
    tops.sddmm(u, v)
    tops.gathered_sddmm(u, v, i, j)
    tops.gathered_sddmm_padded(u.float(), v, i.reshape(3, 1))
    tops.gathered_gram_and_rhs(v, i.reshape(1, 3), torch.ones(1, 3),
                               torch.ones(1, 3), torch.tensor(2.0))
    assert tops.launch_counts() == {
        "gram": 0, "gram_gathered_bf16": 0, "sddmm": 0, "sddmm_bf16": 0,
        "sddmm_gathered": 0, "sddmm_gathered_bf16": 0,
        "sddmm_padded_bf16": 0, "sddmm_padded_mixed": 0, "topk_score": 0, "topk_score_bf16": 0,
        "flash": 0, "flash_bwd": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper never falls back to the plain version."""
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tgram.gram_cuda(*_t(*_gram_inputs(2, 3, 4)))
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tsddmm.sddmm_cuda(*_t(*_sddmm_inputs(5, 4)))
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tsddmm.sddmm_padded_cuda(*_t(*_sddmm_inputs(5, 4)),
                                 *_t(np.zeros((5, 2), np.int32)))


def test_probe_envelope_mirrors_reference():
    """The port's probes are the reference's fp32 probes: the operands'
    shapes, and for topk_score the k its probe call asks for.  gram's
    are all three of the reference's (the bf16 one included), with
    their shapes and dtypes; flash's all three of the reference's, with
    their dtypes (``test_torch_flash.py`` holds their masking
    arguments).  ``sddmm_gathered`` is the port's own entry: its
    production probe is sddmm's production shape.  ``flash_bwd`` is the
    port's own too (the reference has no Pallas backward): flash's
    probes, then GQA groups of 3 at hd 64.  ``sddmm_bf16`` and
    ``topk_score_bf16`` are the port's own: sddmm's and topk_score's
    probes, run in bf16."""
    for name, probes in tops.KERNELS.items():
        if name in ("sddmm_bf16", "topk_score_bf16"):
            fp32 = tops.KERNELS[name[:-len("_bf16")]]
            assert probes == {f"{label} bf16": p
                              for label, p in fp32.items()}
            continue
        if name == "flash_bwd":
            own = {label: p for label, p in probes.items()
                   if label not in tops.KERNELS["flash"]}
            assert {label: p for label, p in probes.items()
                    if label not in own} == tops.KERNELS["flash"]
            assert own and all(q[2] == 3 * kv[2] and q[3] == kv[3] == 64
                               for q, kv, _, _ in own.values())
            continue
        if name == "sddmm_gathered":
            E, K = probes["production e4096 K128"][:2]
            assert (E, K) == tops.KERNELS["sddmm"]["production e4096 K128"]
            continue
        if name == "gram":
            ref_all = {p.label: p for p in jops.KERNELS[name].probes}
            assert set(probes) == set(ref_all)
            for label, (shape, dtype) in probes.items():
                args = ref_all[label].args
                assert shape == args[0].shape
                assert all(str(dtype) == f"torch.{a.dtype}" for a in args)
            continue
        if name == "flash":
            ref_all = {p.label: p for p in jops.KERNELS[name].probes}
            assert set(probes) == set(ref_all)
            for label, (q, kv, dtype, _) in probes.items():
                args = ref_all[label].args
                assert (q, kv, kv) == tuple(a.shape for a in args)
                assert str(dtype) == f"torch.{args[0].dtype}"
            continue
        ref_fp32 = {p.label: p for p in jops.KERNELS[name].probes
                    if p.args[0].dtype == jnp.float32}
        assert set(probes) == set(ref_fp32)
        for label, shape in probes.items():
            p = ref_fp32[label]
            if name != "topk_score":
                assert shape == p.args[0].shape
                continue
            us, v, k = shape
            assert (us, v) == (p.args[0].shape, p.args[1].shape)
            ids = jax.eval_shape(p.call, *p.args)[0]
            assert ids.shape == (us[0], k)


def _gathered_inputs(R, T, K, n_fixed, empty_rows, seed):
    rng = np.random.default_rng(seed)
    fixed = rng.normal(size=(n_fixed, K)).astype(np.float32)
    idx = rng.integers(0, n_fixed, size=(R, T)).astype(np.int32)
    val = rng.normal(size=(R, T)).astype(np.float32)
    mask = (rng.random((R, T)) > 0.3).astype(np.float32)
    mask[:empty_rows] = 0.0
    return fixed, idx, val, mask


# K = 1, 7, 33 and 128; T not a multiple of the kernel's 16-step
# stages; rows with no entry
@pytest.mark.parametrize("R,T,K,n_fixed,empty", [
    (3, 5, 1, 4, 1), (9, 37, 7, 20, 2), (13, 257, 33, 50, 3),
    (16, 40, 128, 300, 2)])
def test_gathered_gram_matches_jax_two_block_order(R, T, K, n_fixed, empty):
    """Two blocks of one entity through ``ops.gathered_gram_and_rhs``,
    the second with acc and a Lambda_p that is not symmetric, against
    the reference's ``(a1 * gram_and_rhs(fixed1[idx1]) + a2 *
    gram_and_rhs(fixed2[idx2])) + Lambda_p`` (jnp oracle and the Pallas
    kernel in interpret mode) at GRAM_TOL; and bitwise against the
    separate ops it replaces (gather, gram_ref, mul_, add_, add_)."""
    f1, i1, v1, m1 = _gathered_inputs(R, T, K, n_fixed, empty, 0)
    f2, i2, v2, m2 = _gathered_inputs(R, T + 3, K, n_fixed + 5, 0, 1)
    a1, a2 = np.float32(1.7), np.float32(0.45)
    lam = np.random.default_rng(2).normal(size=(K, K)).astype(np.float32)
    assert K == 1 or not np.array_equal(lam, lam.T)
    tf1, ti1, tv1, tm1, tf2, ti2, tv2, tm2, tlam = _t(
        f1, i1, v1, m1, f2, i2, v2, m2, lam)
    ta1, ta2 = torch.tensor(a1), torch.tensor(a2)
    acc = tops.gathered_gram_and_rhs(tf1, ti1, tv1, tm1, ta1)
    g, r = tops.gathered_gram_and_rhs(tf2, ti2, tv2, tm2, ta2, acc=acc,
                                      lam=tlam)
    assert g.data_ptr() == acc[0].data_ptr()   # updated in place

    def jax_side(use_pallas):
        outs = []
        for f, i, v, m in ((f1, i1, v1, m1), (f2, i2, v2, m2)):
            outs.append(jops.gram_and_rhs(
                jnp.asarray(f)[jnp.asarray(i)], jnp.asarray(v),
                jnp.asarray(m), use_pallas=use_pallas, interpret=True))
        (g1, r1), (g2, r2) = outs
        return (a1 * g1 + a2 * g2) + jnp.asarray(lam), a1 * r1 + a2 * r2

    for jg, jr in (jax_side(False), jax_side(True)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAM_TOL)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), **GRAM_TOL)

    # the float program of the separate ops, to the bit
    def slab(f, i):
        return f.index_select(0, i.reshape(-1)).reshape(*i.shape, K)
    wg, wr = tref.gram_ref(slab(tf1, ti1), tv1, tm1)
    wg.mul_(ta1)
    wr.mul_(ta1)
    g2_, r2_ = tref.gram_ref(slab(tf2, ti2), tv2, tm2)
    wg.add_(g2_.mul_(ta2)).add_(tlam)
    wr = wr + r2_.mul_(ta2)
    assert torch.equal(g, wg) and torch.equal(r, wr)


def test_gathered_gram_cpu_launches_no_kernel_and_wrapper_refuses_cpu():
    fixed, idx, val, mask = _t(*_gathered_inputs(2, 3, 4, 5, 0, 0))
    tops.reset_launch_counts()
    tops.gathered_gram_and_rhs(fixed, idx, val, mask, torch.tensor(2.0))
    assert tops.launch_counts()["gram"] == 0
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tgram.gathered_gram_cuda(fixed, idx, val, mask, torch.tensor(2.0))


# the reference's bf16 probe, and a ragged shape
@pytest.mark.parametrize("R,T,K", [(16, 130, 32), (5, 37, 9)])
def test_gram_bf16_plain_matches_jax_oracle_and_pallas(R, T, K):
    """bf16 operands (the reference's ``bf16_gather`` probe) through
    ``ops.gram_and_rhs``'s plain version against the reference's bf16
    oracle and the Pallas kernel in interpret mode.  Tolerance GRAM_TOL:
    bf16 widens to fp32 exactly, and with masks of 0 and 1 the programs
    (bf16 masked operand and val * mask; fp32 in the Pallas kernel)
    differ only in the order of the fp32 sums."""
    vg, val, mask = _gram_inputs(R, T, K, seed=3)
    bf = [torch.from_numpy(a).bfloat16() for a in (vg, val, mask)]
    g, r = tops.gram_and_rhs(*bf)
    assert g.dtype == r.dtype == torch.float32
    jin = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in bf]
    jg, jr = jref.gram_ref(*jin)
    pg, pr = jops.gram_and_rhs(*jin, use_pallas=True, interpret=True)
    for want_g, want_r in ((jg, jr), (pg, pr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g),
                                   **GRAM_TOL)
        np.testing.assert_allclose(r.numpy(), np.asarray(want_r),
                                   **GRAM_TOL)
