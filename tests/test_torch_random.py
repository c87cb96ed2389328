"""The port's threefry stream against ``jax.random``.

Keys, raw bits and uniforms must be bitwise equal to JAX in the
non-partitionable layout the golden chains were pinned on.  Normals may
differ by a few ulps (``log1p`` differs between XLA and torch inside
``erf_inv``), and so may gammas, whose Marsaglia-Tsang loop also calls
``log``, ``sqrt`` and ``pow``.  Every JAX call runs inside
``jax.threefry_partitionable(False)``, which restores the global
setting when it exits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gibbs as jgibbs
from repro_torch import random as trandom
from repro_torch.core import gibbs as tgibbs
from torch_threads import _one_thread  # noqa: F401 (autouse)

SEEDS = [0, 11, 12345, -3]
# normal(): erf_inv's log1p differs by an ulp between XLA and torch; the
# polynomial turns that into at most a few ulps of the result
NORMAL_ULPS = 4


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), 1e-30))


def _u32(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in_bitwise(seed):
    with jax.threefry_partitionable(False):
        k = jax.random.PRNGKey(seed)
        tk = trandom.PRNGKey(seed)
        assert np.array_equal(_u32(k), tk.numpy())
        for n in (1, 2, 3, 5, 8):
            assert np.array_equal(_u32(jax.random.split(k, n)),
                                  trandom.split(tk, n).numpy())
        for d in (0, 1, 7, 100000, 2**31 + 5):
            assert np.array_equal(_u32(jax.random.fold_in(k, d)),
                                  trandom.fold_in(tk, d).numpy())


def test_fold_in_batched_equals_loop():
    with jax.threefry_partitionable(False):
        k = jax.random.PRNGKey(3)
        want = np.stack([_u32(jax.random.fold_in(k, r)) for r in range(9)])
    got = trandom.fold_in(trandom.PRNGKey(3), torch.arange(9)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(), (1,), (7,), (4, 6), (33, 5)])
def test_bits_and_uniform_bitwise(shape):
    with jax.threefry_partitionable(False):
        for seed in SEEDS:
            k = jax.random.PRNGKey(seed)
            tk = trandom.PRNGKey(seed)
            n = int(np.prod(shape))
            assert np.array_equal(
                _u32(jax.random.bits(k, shape, jnp.uint32)),
                trandom.random_bits(tk, n).reshape(shape).numpy())
            assert np.array_equal(np.asarray(jax.random.uniform(k, shape)),
                                  trandom.uniform(tk, shape).numpy())
            assert np.array_equal(
                np.asarray(jax.random.uniform(k, shape, minval=0.3,
                                              maxval=2.5)),
                trandom.uniform(tk, shape, 0.3, 2.5).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_few_ulps(seed):
    with jax.threefry_partitionable(False):
        a = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                         (64, 33)))
    b = trandom.normal(trandom.PRNGKey(seed), (64, 33)).numpy()
    assert _ulps(a, b).max() <= NORMAL_ULPS


def test_erf_inv_within_few_ulps():
    u = np.linspace(-0.9999999, 0.9999999, 20001).astype(np.float32)
    a = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    b = trandom.erf_inv(torch.from_numpy(u)).numpy()
    assert _ulps(a, b).max() <= NORMAL_ULPS
    assert np.isinf(trandom.erf_inv(torch.tensor([1.0, -1.0])).numpy()).all()


# NW chi^2 shapes (df - i) / 2 with df = K + N, AdaptiveGaussian's
# a0 + nnz / 2 at a small and at the slice's nnz, and a boosted a < 1
@pytest.mark.parametrize("a", [
    (np.float32(8 + 48) - np.arange(8, dtype=np.float32)) / 2,
    np.float32(0.5 + 0.5 * 461),
    np.float32(0.5 + 0.5 * 8388608),
    np.float32(0.7),
])
def test_gamma_matches_jax(a):
    for seed in SEEDS:
        with jax.threefry_partitionable(False):
            want = np.asarray(jax.random.gamma(jax.random.PRNGKey(seed), a))
        got = trandom.gamma(trandom.PRNGKey(seed), torch.tensor(a)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_row_normals_match_jax_and_slice_invariant():
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(5)
        want = np.asarray(jgibbs.row_normals(key, 10, 6))
    tkey = trandom.PRNGKey(5)
    full = tgibbs.row_normals(tkey, 10, 6)
    assert _ulps(want, full.numpy()).max() <= NORMAL_ULPS
    # a shard holding rows [3, 7) draws exactly the full draw's rows
    shard = tgibbs.row_normals(tkey, 4, 6, row_offset=3)
    assert torch.equal(shard, full[3:7])
