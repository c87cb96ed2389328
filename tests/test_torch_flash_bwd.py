"""The port's attention gradient against the JAX package's, on the CPU.

On the CPU ``repro_torch.kernels.ops.flash_attention_bwd`` runs the
plain version ``ref.attention_bwd_ref`` (the CUDA kernels
``csrc/flash_bwd_sm90.cu`` and ``csrc/flash_bwd.cu`` need the card:
``test_torch_kernels_cuda.py`` and ``chip_smoke.py`` hold them against
this plain version; here ``design()`` and the C entries' signatures).  It is held
against ``jax.vjp`` of the reference's ``layers.flash_attention`` (the
jnp custom_vjp whose backward ``_flash_vjp_bwd`` the kernel stands for)
and of ``layers.chunked_attention`` (the model path's attention under
plain autodiff), and against ``torch.autograd.grad`` through the port's
``ref.attention_ref``: causal with GQA groups of 1, 2 and 3, windowed
from an offset (fully masked rows included), and non-causal; and at two
widths (v and dout narrower than q and k, as in MLA's prefill, up to
DeepSeek-V2-Lite's 192 against 128), where the scale is 1/sqrt of q's
width.

Fully masked rows: the reference's model path masks with -1e30, so a
row that sees no key there takes the mean of v (and passes gradient to
every key), where the port's kernels and both packages' ``attention_ref``
return 0 (the ``l == 0`` guard).  Against the -1e30 paths those rows get
dout = 0, so that they contribute nothing on either side; against
``attention_ref`` (autograd) every row has a random dout.

Tolerance, fp32: |port - reference| <= 1e-5 (|reference| + m), m the
sum of the magnitudes of the output's terms
(``ref.attention_bwd_magnitude``): the same fp32 function summed in
another order (rounding errors grow with the sum of |terms|), plus
1e-7 absolute where both sides are 0 up to rounding.  The row
log-sum-exp: 1e-6 (1 + |lse|) against the reference's ``m + log(l)``.
"""
import ctypes
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import _flash_fwd as jflash_fwd
from repro.models.layers import chunked_attention
from repro.models.layers import flash_attention as jflash
from repro_torch.kernels import _build
from repro_torch.kernels import flash as tflash
from repro_torch.kernels import flash_bwd as tflash_bwd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tL
from torch_threads import _one_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-5, 1e-7

# (label, q shape, k shape, v width, masking arguments, chunk of the
# reference's flash_attention and chunked_attention); v and dout are
# the v width wide, narrower than q and k in the two-width rows (MLA's
# prefill, q/k nope + rope against v_head_dim)
CASES = [
    ("causal G1", (2, 48, 4, 16), (2, 48, 4, 16), 16, dict(causal=True),
     16),
    ("causal G2", (1, 64, 4, 32), (1, 64, 2, 32), 32, dict(causal=True),
     32),
    ("causal G3 smollm", (2, 40, 9, 64), (2, 40, 3, 64), 64,
     dict(causal=True), 40),
    ("windowed offset, masked rows", (1, 24, 4, 8), (1, 20, 2, 8), 8,
     dict(causal=True, window=3, q_offset=19), 8),
    ("windowed offset G3", (2, 30, 6, 16), (2, 50, 2, 16), 16,
     dict(causal=True, window=12, q_offset=20), 10),
    ("noncausal G2 sk ragged", (2, 20, 4, 8), (2, 33, 2, 8), 8,
     dict(causal=False), 20),
    ("two widths 24/16 causal G1", (2, 40, 4, 24), (2, 40, 4, 24), 16,
     dict(causal=True), 8),
    ("two widths 24/16 windowed offset G2", (1, 30, 4, 24),
     (1, 50, 2, 24), 16, dict(causal=True, window=12, q_offset=20), 10),
    ("two widths 192/128 causal", (1, 16, 2, 192), (1, 16, 2, 192), 128,
     dict(causal=True), 8),
    ("two widths 40/24 noncausal sk ragged", (2, 20, 4, 40),
     (2, 33, 2, 40), 24, dict(causal=False), 20),
]
IDS = [c[0] for c in CASES]
PARAMS = "label,q_shape,kv_shape,hdv,kw,chunk"


def _inputs(q_shape, kv_shape, seed=0, hdv=None):
    """q, k, v and dout from numpy; v and dout ``hdv`` wide (default
    q's width)."""
    rng = np.random.default_rng(seed)
    hdv = q_shape[-1] if hdv is None else hdv
    v_shape, g_shape = kv_shape[:3] + (hdv,), q_shape[:3] + (hdv,)
    q, k, v, g = (rng.normal(size=s).astype(np.float32)
                  for s in (q_shape, kv_shape, v_shape, g_shape))
    return q, k, v, g


def _port(q, k, v, g, kw):
    """(out, lse, (dq, dk, dv)) of the port's plain forward and
    backward, fp32 on the CPU."""
    t = [torch.from_numpy(x) for x in (q, k, v, g)]
    out, lse = tops.flash_attention_fwd(*t[:3], **kw)
    grads = tops.flash_attention_bwd(*t[:3], out, lse, t[3], **kw)
    return t, out, lse, grads


def _visible(Sq, Sk, kw):
    """(Sq,) bool: the query rows that see at least one key."""
    if not kw.get("causal"):
        return np.full(Sq, Sk > 0)
    qpos = kw.get("q_offset", 0) + np.arange(Sq)
    lo = qpos - kw["window"] + 1 if kw.get("window") else np.zeros(Sq)
    return (np.minimum(qpos, Sk - 1) >= np.maximum(lo, 0))


def _close(t, out, lse, got, want, g, kw, what):
    mags = tref.attention_bwd_magnitude(*t[:3], out, lse, g, **kw)
    for name, a, b, m in zip(("dq", "dk", "dv"), got, want, mags):
        a, b, m = a.numpy(), np.asarray(b, np.float32), m.numpy()
        assert np.isfinite(a).all()
        bad = np.abs(a - b) > RTOL * (np.abs(b) + m) + ATOL
        assert not bad.any(), (what, name, np.abs(a - b).max(),
                               int(bad.sum()))


def _jax_vjp(fn, q, k, v, g):
    with jax.threefry_partitionable(False):
        _, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
        return vjp(jnp.asarray(g))


@pytest.mark.parametrize(PARAMS, CASES, ids=IDS)
def test_plain_backward_matches_reference_flash_vjp(label, q_shape,
                                                    kv_shape, hdv, kw, chunk):
    q, k, v, g = _inputs(q_shape, kv_shape, hdv=hdv)
    g[:, ~_visible(q_shape[1], kv_shape[1], kw)] = 0.0
    t, out, lse, got = _port(q, k, v, g, kw)
    causal, window, q_offset = (kw["causal"], kw.get("window", 0),
                                kw.get("q_offset", 0))
    want = _jax_vjp(lambda a, b, c: jflash(a, b, c, causal, window,
                                           q_offset, chunk), q, k, v, g)
    _close(t, out, lse, got, want, t[3], kw, "flash_attention vjp")


@pytest.mark.parametrize(PARAMS, CASES, ids=IDS)
def test_plain_backward_matches_reference_chunked_attention(
        label, q_shape, kv_shape, hdv, kw, chunk):
    q, k, v, g = _inputs(q_shape, kv_shape, seed=1, hdv=hdv)
    g[:, ~_visible(q_shape[1], kv_shape[1], kw)] = 0.0
    t, out, lse, got = _port(q, k, v, g, kw)
    want = _jax_vjp(lambda a, b, c: chunked_attention(a, b, c, chunk=chunk,
                                                      **kw), q, k, v, g)
    _close(t, out, lse, got, want, t[3], kw, "chunked_attention vjp")


@pytest.mark.parametrize(PARAMS, CASES, ids=IDS)
def test_plain_backward_matches_autograd_through_plain_forward(
        label, q_shape, kv_shape, hdv, kw, chunk):
    q, k, v, g = _inputs(q_shape, kv_shape, seed=2, hdv=hdv)
    t, out, lse, got = _port(q, k, v, g, kw)
    leaves = [x.clone().requires_grad_() for x in t[:3]]
    want = torch.autograd.grad(tref.attention_ref(*leaves, **kw), leaves,
                               t[3])
    _close(t, out, lse, got, want, t[3], kw, "autograd")
    if not _visible(q_shape[1], kv_shape[1], kw).all():
        assert torch.isinf(lse).any() and (got[0][:, ~torch.from_numpy(
            _visible(q_shape[1], kv_shape[1], kw))] == 0).all()


@pytest.mark.parametrize(PARAMS, CASES, ids=IDS)
def test_lse_matches_reference_row_statistics(label, q_shape, kv_shape, hdv,
                                              kw, chunk):
    """lse = m + log(l) of the reference's flash forward on the rows
    that see a key; +inf on the others."""
    q, k, v, _ = _inputs(q_shape, kv_shape, seed=3, hdv=hdv)
    _, lse = tref.attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                **kw, return_lse=True)
    with jax.threefry_partitionable(False):
        _, ms, ls = jflash_fwd(*(jnp.asarray(x) for x in (q, k, v)),
                               kw["causal"], kw.get("window", 0),
                               kw.get("q_offset", 0), chunk)
    # (n, B, KVH, G, C) -> (B, H, Sq)
    n, B, KVH, G, C = ms.shape
    want = np.asarray(ms + jnp.log(ls)).transpose(1, 2, 3, 0, 4).reshape(
        B, KVH * G, n * C)
    seen = _visible(q_shape[1], kv_shape[1], kw)
    got = lse.numpy()
    assert np.isinf(got[..., ~seen]).all() and (got[..., ~seen] > 0).all()
    np.testing.assert_allclose(got[..., seen], want[..., seen], rtol=1e-6,
                               atol=1e-6)


def test_attention_fn_gradient_is_the_plain_backward():
    """Under autograd the layers' attention_fn runs the Function (plain
    forward with lse, plain backward on the CPU); without autograd it is
    ops.flash_attention, the same output bits."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs((2, 20, 6, 16),
                                                       (2, 20, 2, 16)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tL.attention_fn(*leaves, causal=True)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), tops.flash_attention(q, k, v,
                                                          causal=True))
    got = torch.autograd.grad(out, leaves, g)
    _, lse = tref.attention_ref(q, k, v, causal=True, return_lse=True)
    want = tref.attention_bwd_ref(q, k, v, out.detach(), lse, g,
                                  causal=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with torch.no_grad():
        plain = tL.attention_fn(*leaves, causal=True)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())


def test_cpu_gradient_entries_launch_no_kernel():
    tops.reset_launch_counts()
    q, k, v, g = (torch.from_numpy(x) for x in _inputs((1, 8, 2, 8),
                                                       (1, 8, 1, 8)))
    out, lse = tops.flash_attention_fwd(q, k, v, causal=True)
    tops.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    assert tops.launch_counts()["flash"] == 0
    assert tops.launch_counts()["flash_bwd"] == 0
    assert set(tflash_bwd.design_launches.values()) == {0}


@pytest.mark.parametrize("pair", [
    pytest.param(p, id=str(p[0]) if p[0] == p[1] else f"{p[0]}/{p[1]}")
    for p in tflash_bwd.SM90_HEAD_DIMS])
def test_cpu_bf16_gradient_at_the_hopper_widths_launches_no_kernel(pair):
    """bf16 at the (q/k, v) widths the card sends to flash_bwd_sm90 runs
    the plain version on the CPU: no design counts a launch, and the
    gradient is ``attention_bwd_ref``'s bits."""
    hd, hdv = pair
    tops.reset_launch_counts()
    q, k, v, g = (torch.from_numpy(x).bfloat16() for x in _inputs(
        (1, 12, 4, hd), (1, 12, 2, hd), hdv=hdv))
    out, lse = tops.flash_attention_fwd(q, k, v, causal=True)
    got = tops.flash_attention_bwd(q, k, v, out, lse, g, causal=True)
    want = tref.attention_bwd_ref(q, k, v, out, lse, g, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [tuple(x.shape) for x in got] == [(1, 12, 4, hd), (1, 12, 2, hd),
                                             (1, 12, 2, hdv)]
    assert tops.launch_counts()["flash_bwd"] == 0
    assert set(tflash_bwd.design_launches.values()) == {0}


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "flash_bwd_sm90"),
    (torch.bfloat16, 128, "flash_bwd_sm90"),
    (torch.float32, 64, "flash_bwd"),
    (torch.float32, 128, "flash_bwd"),
    (torch.bfloat16, 8, "flash_bwd"),
    (torch.bfloat16, 32, "flash_bwd"),
    (torch.bfloat16, 120, "flash_bwd"),
    pytest.param(torch.bfloat16, (192, 128), "flash_bwd_sm90",
                 id="bf16-192/128-flash_bwd_sm90"),
    pytest.param(torch.bfloat16, (24, 16), "flash_bwd",
                 id="bf16-24/16-flash_bwd"),
    pytest.param(torch.float32, (192, 128), "flash_bwd",
                 id="fp32-192/128-flash_bwd"),
    pytest.param(torch.bfloat16, (128, 64), "flash_bwd",
                 id="bf16-128/64-flash_bwd")])
def test_backward_design_routes_by_dtype_and_head_width(dtype, hd, want):
    """bf16 at the (q/k, v) pairs 64/64, 128/128 and 192/128 (``hd``
    alone: q, k and v that wide) goes to the Hopper design, fp32 and the
    other widths, one or two, to flash_bwd.cu; every source has a ctypes
    row and a launch count."""
    hd, hdv = hd if isinstance(hd, tuple) else (hd, hd)
    assert tflash_bwd.design(dtype, hd, hdv) == want
    if hd == hdv:
        assert tflash_bwd.design(dtype, hd) == want
    assert want in _build._SIGNATURES
    assert set(tflash_bwd.design_launches) == {"flash_bwd_sm90",
                                               "flash_bwd"}


def test_cuda_backward_wrapper_refuses_cpu_tensors():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs((1, 8, 2, 8),
                                                       (1, 8, 1, 8)))
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tflash_bwd.flash_bwd_cuda(q, k, v, q, lse, g, causal=True)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tflash.flash_cuda(q, k, v, causal=True, return_lse=True)


def _c_params(source, entry):
    src = (_build.CSRC / f"{source}.cu").read_text()
    sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1)
    return [p.split()[-1].lstrip("*") for p in sig.split(",")]


def test_backward_signature_fits_the_c_entry():
    """The wrapper's ctypes signature is the C entry's: ten pointers,
    eleven int64 sizes and flags (v's width ``hdv`` after ``hd``), the
    stream."""
    params = _c_params("flash_bwd", "flash_bwd")
    ((name, argtypes),) = _build._SIGNATURES["flash_bwd"].items()
    assert name == "flash_bwd" and len(argtypes) == len(params)
    assert params[:10] == ["q", "k", "v", "out", "dout", "lse", "delta",
                           "dq", "dk", "dv"]
    assert all(t is ctypes.c_void_p for t in argtypes[:10])
    assert params[10:-1] == ["B", "Sq", "Sk", "H", "KVH", "hd", "hdv",
                             "causal", "window", "q_offset", "is_bf16"]
    assert all(t is ctypes.c_int64 for t in argtypes[10:-1])
    assert argtypes[-1] is ctypes.c_void_p and params[-1] == "stream"


def test_hopper_backward_signature_fits_its_c_entry():
    """flash_bwd_sm90.cu's entry takes flash_bwd.cu's arguments, and its
    ctypes row is flash_bwd's: ten pointers, eleven int64 (``hdv`` after
    ``hd``), the stream; its dispatch instantiates exactly the pairs
    that ``design`` sends it."""
    params = _c_params("flash_bwd_sm90", "flash_bwd_sm90")
    ((name, argtypes),) = _build._SIGNATURES["flash_bwd_sm90"].items()
    assert name == "flash_bwd_sm90" and len(argtypes) == len(params)
    assert params == _c_params("flash_bwd", "flash_bwd")
    assert argtypes == _build._SIGNATURES["flash_bwd"]["flash_bwd"]
    assert all(t is ctypes.c_void_p for t in argtypes[:10])
    assert all(t is ctypes.c_int64 for t in argtypes[10:-1])
    assert params[15:17] == ["hd", "hdv"]
    assert argtypes[-1] is ctypes.c_void_p and params[-1] == "stream"
    src = (_build.CSRC / "flash_bwd_sm90.cu").read_text()
    entry = src[src.index('extern "C" int flash_bwd_sm90('):]
    launched = {tuple(map(int, m)) for m in
                re.findall(r"launch<(\d+), (\d+)>\(q", entry)}
    assert launched == set(tflash_bwd.SM90_HEAD_DIMS)


def test_first_backward_design_is_the_source_timed_as_previous():
    """chip_smoke.py times the first bf16 design beside the Hopper one by
    launching flash_bwd.cu by name; the report's previous_source is that
    file, which still takes bf16 at 64/64, 128/128 and 192/128."""
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke_names",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    src = _build._source("flash_bwd")
    assert (root / cs.PREVIOUS_FLASH_BWD).resolve() == src.resolve()
    text = src.read_text()
    assert "launch_bf16<64, 64, 2>(a" in text
    assert "launch_bf16<128, 128, 2>(a" in text
    assert "launch_bf16<HD_MAX, HDV_MAX, 1>(a" in text
    assert "constexpr int HD_MAX = 192;" in text
    assert "constexpr int HDV_MAX = 128;" in text


@pytest.mark.parametrize("source,entry", [("flash", "flash_fwd"),
                                          ("flash_sm90", "flash_sm90_fwd")])
def test_forward_entries_take_the_lse_address_after_q_offset(source, entry):
    params = _c_params(source, entry)
    i = params.index("lse")
    assert params[i - 1] == "q_offset"
    q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 4, 1, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 4)
    with_lse = tflash.launch_args(q, k, k, q, causal=True, window=0,
                                  q_offset=0, source=source, lse=lse)
    assert with_lse[i] == lse.data_ptr()
    assert tflash.launch_args(q, k, k, q, causal=True, window=0,
                              q_offset=0, source=source)[i] == 0
