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
    assert tops.launch_counts() == {"gram": 0, "sddmm": 0, "topk_score": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper never falls back to the plain version."""
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tgram.gram_cuda(*_t(*_gram_inputs(2, 3, 4)))
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tsddmm.sddmm_cuda(*_t(*_sddmm_inputs(5, 4)))


def test_probe_envelope_mirrors_reference():
    """The port's probes are the reference's fp32 probes: the operands'
    shapes, and for topk_score the k its probe call asks for."""
    for name, probes in tops.KERNELS.items():
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
