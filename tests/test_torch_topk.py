"""The port's top-K scoring against the JAX package's.

On the CPU ``repro_torch.kernels.ops.topk_score`` runs the plain version
``ref.topk_score_ref``; it is held against ``repro``'s
``ops.topk_score`` through both its jnp reference and its Pallas kernel
in interpret mode, at the reference's three ``ops.KERNELS`` probes, and
through the jnp reference at shapes the card refused before the kernel's
redesign (S*K above 54,000 floats, k above 1,024).  The CUDA kernel
needs the card: ``test_torch_kernels_cuda.py`` and ``chip_smoke.py``
hold it against the plain version.

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
from torch_threads import _one_thread  # noqa: F401 (autouse)

PROBES = list(tops.KERNELS["topk_score"].items())
# shapes the card refused before the kernel streamed a user's rows in
# sample tiles (S*K above 54,000 floats) and selected k above 1,024;
# held to the reference's jnp path (its Pallas kernel unrolls k steps)
LARGE = [("rows above shared memory b2 s480 n300 K128 k50",
          ((2, 480, 128), (480, 300, 128), 50)),
         ("k above 1024 + exclusions b2 s4 n3000 K16 k2048",
          ((2, 4, 16), (4, 3000, 16), 2048))]
CASES = [pytest.param(label, probe, use_pallas, id=f"{name}-{label}")
         for use_pallas, name in ((False, "jnp-reference"),
                                  (True, "pallas-interpret"))
         for label, probe in PROBES] + \
        [pytest.param(label, probe, False, id=f"jnp-reference-{label}")
         for label, probe in LARGE]


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


@pytest.mark.parametrize("label,probe,use_pallas", CASES)
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
    (8, 8192, 100, (64, "chunk", 8192, 81, 1, 0)),      # compound -> proteins
    (8, 131072, 100, (256, "chunk", 8192, 81, 16, 1)),  # protein -> compounds
    (1, 8192, 100, (64, "chunk", 8192, 81, 1, 0)),
    (3, 130, 7, (32, "chunk", 256, 1170, 1, 0)),
    (2, 70000, 1024, (256, "chunk", 8192, 8, 9, 2)),
])
def test_plan_picks_chunks_and_merge_rounds(B, N, k, want):
    """Scoring tiles shrink while the halved grid still fits one wave;
    a selecting block takes a chunk of up to 8,192 items, and rounds
    over groups of 8,192 // k lists fold them to one."""
    assert tuple(ttopk.plan(B, N, k)) == want


def test_plan_refuses_k_above_the_chunk():
    """The chunk no longer bounds k: k = 1,025 and k = N take the radix
    route (survivors sorted in tiles of 4,096, merged in pairs), and
    only k outside [1, N] is refused."""
    assert tuple(ttopk.plan(1, 5000, 1025)) == (64, "radix", 4096, 2, 1, 0)
    assert tuple(ttopk.plan(8, 8192, 8192)) == (64, "radix", 4096, 2, 2, 1)
    assert ttopk.plan(2, 70000, 70000).merges == 5
    assert ttopk.plan(8, 8192, 1024).route == "chunk"
    for k in (0, 5001):
        with pytest.raises(ValueError, match=r"must be in \[1, N=5000\]"):
            ttopk.plan(1, 5000, k)


@pytest.mark.parametrize("B,N,k", [(8, 131072, 100), (2, 70000, 1024),
                                   (8, 8192, 2048), (3, 5000, 5000)])
def test_scratch_holds_the_scores_and_two_sets_of_runs(B, N, k):
    """12 bytes of scratch per (user, item) and two sets of the first
    sort's runs of 64-bit keys, each part 256-byte aligned."""
    p = ttopk.plan(B, N, k)
    runs = B * k * (p.lists if p.route == "chunk" else 1)
    got = ttopk.scratch_bytes(B, N, k, p)
    assert got % 256 == 0
    assert 12 * B * N + 16 * runs <= got < 12 * B * N + 16 * runs + 5 * 256


def test_exact_ties_above_1024_go_to_the_lowest_id():
    """Duplicated rows tie exactly; at k above 1,024 (the card's radix
    route) the plain version keeps the reference's stable order."""
    us, v, _ = _inputs((2, 3, 8), (3, 3000, 8), seed=4)
    v[:, 2000:2600] = v[:, 100:700]     # item 2000 + i duplicates 100 + i
    ids, mean, _ = _port(us, v, 2048, None)
    jids, _, _ = _jax(us, v, 2048, None)
    np.testing.assert_array_equal(ids.numpy(), jids)
    for b in range(2):
        row = ids[b].tolist()
        pos = {d: i for i, d in enumerate(row)}
        tied = [d for d in range(2000, 2600) if d in pos]
        assert tied
        for d in tied:
            assert pos[d - 1900] < pos[d]
            assert mean[b, pos[d]] == mean[b, pos[d - 1900]]
