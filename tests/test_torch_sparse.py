"""The port's padded sparse layout against ``repro.core.sparse``:
the same COO input must give equal arrays in every field."""
import numpy as np
import pytest

from repro.core import sparse as jsparse
from repro_torch.core import sparse as tsparse
from torch_threads import _one_thread  # noqa: F401 (autouse)

FIELDS = ("coo_i", "coo_j", "coo_v", "coo_mask", "coo_rpos", "coo_cpos")


def _assert_same(j, t):
    assert tuple(t.shape) == tuple(j.shape)
    for side in ("rows", "cols"):
        jp, tp = getattr(j, side), getattr(t, side)
        assert tp.n_other == jp.n_other
        for f in ("idx", "val", "mask"):
            a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), (side, f)
    for f in FIELDS:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("n,m,nnz,kw", [
    (40, 25, 300, {}),
    (13, 7, 40, {"round_to": 1}),
    (30, 20, 200, {"max_nnz_row": 24, "max_nnz_col": 32}),
    (5, 300, 77, {"round_to": 16}),
])
def test_from_coo_equals_reference(n, m, nnz, kw):
    rng = np.random.default_rng(n * m + nnz)
    flat = rng.choice(n * m, size=nnz, replace=False)
    i, j = np.divmod(flat, m)
    v = rng.normal(size=nnz).astype(np.float32)
    _assert_same(jsparse.from_coo(i, j, v, (n, m), **kw),
                 tsparse.from_coo(i, j, v, (n, m), device="cpu", **kw))


def test_from_coo_max_nnz_error_matches():
    i, j, v = np.array([0, 0, 0]), np.array([0, 1, 2]), np.ones(3)
    with pytest.raises(ValueError) as je:
        jsparse.from_coo(i, j, v, (2, 3), max_nnz_row=2)
    with pytest.raises(ValueError) as te:
        tsparse.from_coo(i, j, v, (2, 3), max_nnz_row=2, device="cpu")
    assert str(te.value) == str(je.value)


def test_random_sparse_and_transpose_equal_reference():
    jm, jtest, (jU, jV) = jsparse.random_sparse(11, (48, 32), 0.3, rank=3)
    tm, ttest, (tU, tV) = tsparse.random_sparse(11, (48, 32), 0.3, rank=3,
                                                device="cpu")
    _assert_same(jm, tm)
    _assert_same(jm.transpose(), tm.transpose())
    for a, b in zip(jtest + (jU, jV), ttest + (tU, tV)):
        assert np.array_equal(a, b)
    assert float(tm.nnz) == float(jm.nnz)
