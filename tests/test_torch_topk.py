"""The port's top-K scoring against the JAX package's.

On the CPU ``repro_torch.kernels.ops.topk_score`` runs the plain version
``ref.topk_score_ref``; it is held against ``repro``'s
``ops.topk_score`` through both its jnp reference and its Pallas kernel
in interpret mode, at the reference's three ``ops.KERNELS`` probes.  The
CUDA kernel needs the card: ``test_torch_kernels_cuda.py`` and
``chip_smoke.py`` hold it against the plain version.

Tolerance (``ref.check_topk_score``): mean rtol 1e-5 of
(1/S) sum |u| |v|, the magnitude of a score's terms; std 1e-3 *
sqrt(ex2), since std = sqrt(ex2 - mean^2) cancels where the spread is
small against the mean and an error d in ex2 moves std by up to
sqrt(d); ids equal except at near-ties.  Exact ties, signed zeros,
clamping and batching are held exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topk_score as ttopk

PROBES = list(tops.KERNELS["topk_score"].items())


def _inputs(us_shape, v_shape, seed=0, excl_frac=0.0):
    rng = np.random.default_rng(seed)
    us = rng.normal(size=us_shape).astype(np.float32)
    v = rng.normal(size=v_shape).astype(np.float32)
    excl = None
    if excl_frac:
        excl = (rng.random((us_shape[0], v_shape[1])) < excl_frac).astype(
            np.float32)
    return us, v, excl


def _jax(us, v, k, excl, use_pallas=False):
    with jax.threefry_partitionable(False):
        out = jops.topk_score(jnp.asarray(us), jnp.asarray(v), k,
                              exclude=excl, use_pallas=use_pallas,
                              interpret=True if use_pallas else None)
    return [np.asarray(x) for x in out]


def _port(us, v, k, excl):
    return tops.topk_score(torch.from_numpy(us), torch.from_numpy(v), k,
                           exclude=None if excl is None
                           else torch.from_numpy(excl))


@pytest.mark.parametrize("label,probe", PROBES, ids=[p[0] for p in PROBES])
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["jnp-reference", "pallas-interpret"])
def test_plain_topk_matches_reference(label, probe, use_pallas):
    us_shape, v_shape, k = probe
    us, v, excl = _inputs(us_shape, v_shape,
                          excl_frac=0.4 if "exclusions" in label else 0.0)
    got = _port(us, v, k, excl)
    want = _jax(us, v, k, excl, use_pallas)
    tref.check_topk_score(got, [torch.from_numpy(x) for x in want],
                          torch.from_numpy(us), torch.from_numpy(v),
                          f"port vs repro, {label}")


def test_exact_ties_go_to_the_lowest_id():
    us, v, _ = _inputs((3, 4, 8), (4, 300, 8), seed=1)
    v[:, 200:260] = v[:, 10:70]           # item 200 + i duplicates 10 + i
    ids, mean, _ = _port(us, v, 150, None)
    jids, jmean, _ = _jax(us, v, 150, None)
    np.testing.assert_array_equal(ids.numpy(), jids)
    for b in range(3):
        row = ids[b].tolist()
        dups = [d for d in range(200, 260) if d in row]
        assert dups
        for d in dups:
            assert row.index(d - 190) < row.index(d)
            assert mean[b, row.index(d)] == mean[b, row.index(d - 190)]


def test_signed_zero_means_rank_as_equal():
    """-0.0 and +0.0 tie, as in jnp.argsort: zero-mean items rank by id
    whatever their sign, with or without exclusions.  An odd item's
    scores sum to the smallest negative subnormal, which 1/S rounds to
    a mean of -0.0."""
    us = np.ones((2, 3, 1), np.float32)
    v = np.zeros((3, 8, 1), np.float32)
    v[0, 1::2, 0] = -np.float32(1e-45)
    v[0, 6, 0] = 2.0
    excl = np.zeros((2, 8), np.float32)
    excl[1, [0, 3]] = 1.0
    _, plain_mean, _ = tref.topk_score_ref(
        torch.from_numpy(us), torch.from_numpy(v), torch.from_numpy(excl), 8)
    assert np.signbit(plain_mean.numpy()).any()
    ids, mean, _ = _port(us, v, 8, excl)
    jids, _, _ = _jax(us, v, 8, excl)
    np.testing.assert_array_equal(ids.numpy(), jids)
    assert ids.tolist() == [[6, 0, 1, 2, 3, 4, 5, 7],
                            [6, 1, 2, 4, 5, 7, -1, -1]]


def test_batched_call_is_bitwise_b_single_calls():
    us, v, excl = _inputs((6, 8, 16), (8, 500, 16), seed=2, excl_frac=0.2)
    batched = _port(us, v, 20, excl)
    for b in range(6):
        one = _port(us[b:b + 1], v, 20, excl[b:b + 1])
        for x, y in zip(batched, one):      # bits, NaN slots included
            assert torch.equal(x[b:b + 1].view(torch.int32),
                               y.view(torch.int32))


def test_k_above_n_clamps_and_an_all_excluded_row_is_empty():
    us, v, _ = _inputs((3, 4, 8), (4, 30, 8), seed=3)
    excl = np.zeros((3, 30), np.float32)
    excl[1] = 1.0                       # nothing rankable
    excl[2, :28] = 1.0                  # two rankable items
    ids, mean, std = _port(us, v, 45, excl)
    assert ids.shape == (3, 30)
    jids, jmean, jstd = _jax(us, v, 45, excl)
    np.testing.assert_array_equal(ids.numpy(), jids)
    assert (ids[1] == -1).all() and torch.isnan(mean[1]).all() \
        and torch.isnan(std[1]).all()
    assert (ids[2, :2] >= 28).all() and (ids[2, 2:] == -1).all()
    np.testing.assert_array_equal(np.isnan(mean.numpy()), np.isnan(jmean))
    np.testing.assert_array_equal(np.isnan(std.numpy()), np.isnan(jstd))


def test_errors_carry_reference_messages():
    us, v, _ = _inputs((2, 3, 4), (3, 10, 4))
    for k, excl in ((0, None), (3, np.zeros((2, 9), np.float32))):
        with pytest.raises(ValueError) as je:
            _jax(us, v, k, excl)
        with pytest.raises(ValueError) as te:
            _port(us, v, k, excl)
        assert str(te.value) == str(je.value)


def test_cpu_tensors_never_launch_the_kernel():
    tops.reset_launch_counts()
    us, v, excl = _inputs((2, 3, 4), (3, 10, 4), excl_frac=0.3)
    _port(us, v, 4, excl)
    assert tops.launch_counts()["topk_score"] == 0
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        ttopk.topk_score_cuda(torch.from_numpy(us), torch.from_numpy(v),
                              torch.from_numpy(excl), 4)


@pytest.mark.parametrize("B,N,k,want", [
    (8, 8192, 100, (128, 40, 64, 2)),     # compound -> proteins
    (8, 131072, 100, (1024, 40, 128, 2)),  # protein -> compounds
    (1, 8192, 100, (128, 40, 64, 2)),
    (3, 130, 7, (128, 585, 2, 1)),
    (2, 70000, 1024, (1024, 4, 69, 4)),
])
def test_plan_picks_chunks_and_merge_rounds(B, N, k, want):
    """Chunks shrink until the grid fills the card and never below k;
    merge rounds fold the lists to one."""
    assert tuple(ttopk.plan(B, N, k)) == want


def test_plan_refuses_k_above_the_chunk():
    with pytest.raises(ValueError, match="chunk of 1024"):
        ttopk.plan(1, 5000, 1025)
