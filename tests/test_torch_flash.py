"""The port's flash attention against the JAX package's, on the CPU.

On the CPU ``repro_torch.kernels.ops.flash_attention`` runs the plain
version ``ref.attention_ref``; it is held against the reference's
``ref.attention_ref``, its Pallas kernel ``flash_fwd_pallas`` in
interpret mode, and the model path's ``layers.chunked_attention``, at
the reference's three ``ops.KERNELS`` probes and at ragged, offset,
windowed, hd 64 and fully masked cases.  The CUDA kernel needs the
card: ``test_torch_kernels_cuda.py`` and ``chip_smoke.py`` hold it
against the plain version.

Tolerance: fp32, rtol 1e-5 (atol 1e-6 near 0): the same float program
up to summation order.  bf16, one bf16 ulp of the value: both sides
compute in fp32 and round the output to bf16 once, so fp32 differences
of summation order can move a rounding by one place; plus 1e-6
absolute where an output cancels to near 0 (fp32 sums of O(1) terms,
as in fp32).
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash import flash_fwd_pallas
from repro.models.layers import chunked_attention
from repro_torch.kernels import _build
from repro_torch.kernels import flash as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_threads import _one_thread  # noqa: F401 (autouse)

PROBES = [(label, q, kv, dt, kw) for label, (q, kv, dt, kw)
          in tops.KERNELS["flash"].items()]
# (label, q shape, k/v shape, masking arguments), beyond the probes
CASES = [
    ("ragged sq130 sk257 offset window", (2, 130, 4, 16), (2, 257, 2, 16),
     dict(causal=True, window=96, q_offset=100)),
    ("causal offset sq64 sk192", (1, 64, 6, 32), (1, 192, 3, 32),
     dict(causal=True, q_offset=128)),
    ("hd64 smollm G3", (2, 80, 9, 64), (2, 80, 3, 64), dict(causal=True)),
    ("window from 0 sq100", (1, 100, 2, 8), (1, 100, 2, 8),
     dict(causal=True, window=7)),
    ("noncausal sk1", (2, 5, 4, 24), (2, 1, 1, 24), dict(causal=False)),
]


def _qkv(q_shape, kv_shape, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in (q_shape, kv_shape, kv_shape))


def _port(q, k, v, dtype, **kw):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    return tops.flash_attention(*t, **kw).to(torch.float32).numpy()


def _jax(fn, q, k, v, dtype, **kw):
    with jax.threefry_partitionable(False):
        out = fn(*(jnp.asarray(x, dtype) for x in (q, k, v)), **kw)
    return np.asarray(out.astype(jnp.float32))


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        # one ulp of bf16 (8 significant bits) at the larger value
        ulp = np.exp2(np.floor(np.log2(np.maximum(
            np.abs(got), np.abs(want)) + 1e-30)) - 7)
        assert (np.abs(got - want) <= ulp + 1e-6).all(), \
            np.abs(got - want).max()


def _pallas(q, k, v, **kw):
    return flash_fwd_pallas(q, k, v, interpret=True, **kw)


ALL = [(label, q, kv, kw) for label, q, kv, _, kw in PROBES] + CASES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label,q_shape,kv_shape,kw", ALL,
                         ids=[c[0] for c in ALL])
def test_plain_flash_matches_reference_oracle(label, q_shape, kv_shape, kw,
                                              dtype):
    q, k, v = _qkv(q_shape, kv_shape)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    got = _port(q, k, v, tdt, **kw)
    _close(got, _jax(jref.attention_ref, q, k, v, jdt, **kw), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label,q_shape,kv_shape,dt,kw", PROBES,
                         ids=[p[0] for p in PROBES])
def test_plain_flash_matches_pallas_interpret_at_probes(label, q_shape,
                                                        kv_shape, dt, kw,
                                                        dtype):
    q, k, v = _qkv(q_shape, kv_shape, seed=1)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    _close(_port(q, k, v, tdt, **kw), _jax(_pallas, q, k, v, jdt, **kw),
           dtype)


@pytest.mark.parametrize("shape", [((2, 256, 4, 128), (2, 256, 2, 128)),
                                   ((2, 48, 9, 64), (2, 48, 3, 64))],
                         ids=["probe hd128", "smollm hd64"])
def test_plain_flash_matches_model_chunked_attention(shape):
    """The model path's XLA attention, where the port calls the kernel:
    the same function in fp32 (the model path masks with -1e30, the
    kernel with -inf; every causal row from position 0 sees key 0)."""
    q, k, v = _qkv(*shape, seed=2)
    got = _port(q, k, v, torch.float32, causal=True)
    want = _jax(chunked_attention, q, k, v, jnp.float32, causal=True)
    _close(got, want, "float32")


def test_fully_masked_rows_are_zero():
    """A window that ends before the first key leaves rows with nothing
    to see: the l == 0 guard returns 0 there, in both packages."""
    q, k, v = _qkv((1, 8, 2, 8), (1, 4, 1, 8), seed=3)
    kw = dict(causal=True, window=2, q_offset=3)
    got = _port(q, k, v, torch.float32, **kw)
    want = _jax(jref.attention_ref, q, k, v, jnp.float32, **kw)
    assert (got[:, 2:] == 0).all() and (got[:, :2] != 0).any()
    _close(got, want, "float32")


def test_probe_masking_arguments_mirror_reference():
    """The masking arguments of each port probe are those the
    reference's probe call passes to ``flash_fwd_pallas``."""
    for p in jops.KERNELS["flash"].probes:
        cells = [c.cell_contents for c in p.call.__closure__
                 if isinstance(c.cell_contents, dict)]
        assert len(cells) == 1
        assert tops.KERNELS["flash"][p.label][3] == cells[0]


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.zeros(s) for s in ((1, 4, 2, 8), (1, 4, 1, 8),
                                        (1, 4, 1, 8)))
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tflash.flash_cuda(q, k, v, causal=True)
    tops.reset_launch_counts()
    tops.flash_attention(q, k, v, causal=True)
    assert tops.launch_counts()["flash"] == 0       # the CPU path


def test_launch_arguments_fit_the_c_entry():
    """The wrapper's arguments (and the stream) are the C entry's, in
    number and order: strides of strided views, then the sizes."""
    src = (_build.CSRC / "flash.cu").read_text()
    sig = re.search(r'extern "C" int flash_fwd\(([^)]*)\)', src).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    ((name, argtypes),) = _build._SIGNATURES["flash"].items()
    assert name == "flash_fwd" and len(argtypes) == len(params)
    assert argtypes[-1] is ctypes.c_void_p and params[-1] == "stream"
    qkv = torch.zeros(2, 10, 4 + 2 + 2, 16, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    out = torch.empty(2, 10, 4, 16, dtype=torch.bfloat16)
    args = tflash.launch_args(q, k, v, out, causal=True, window=3,
                              q_offset=5)
    named = dict(zip(params, args))
    assert len(args) == len(params) - 1
    assert (named["q_sb"], named["q_ss"], named["q_sh"]) == (1280, 128, 16)
    assert (named["k_sb"], named["v_ss"], named["v_sh"]) == (1280, 128, 16)
    assert [named[n] for n in ("B", "Sq", "Sk", "H", "KVH", "hd", "causal",
                               "window", "q_offset", "is_bf16")] == \
        [2, 10, 10, 4, 2, 16, 1, 3, 5, 1]
    assert named["v"] == v.data_ptr() != q.data_ptr()


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 128, "flash_sm90"), (torch.bfloat16, 64, "flash_sm90"),
    (torch.bfloat16, 16, "flash"), (torch.bfloat16, 8, "flash"),
    (torch.bfloat16, 40, "flash"), (torch.bfloat16, 120, "flash"),
    (torch.float32, 128, "flash"), (torch.float32, 64, "flash")])
def test_design_routes_by_dtype_and_head_width(dtype, hd, want):
    """bf16 at the published configs' head widths goes to the Hopper
    design; fp32 and the other bf16 widths stay on flash.cu."""
    assert tflash.design(dtype, hd) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd,hdv", [(192, 128), (128, 64), (64, 128),
                                    (24, 16)])
def test_design_sends_bf16_192_128_to_sm90_and_other_pairs_to_flash_cu(
        hd, hdv, dtype):
    """A v of another width than q and k: bf16 at MLA's prefill widths
    (q/k 192, v 128) goes to the Hopper design, which instantiates that
    pair; fp32 and every other pair go to flash.cu, whose kernels take
    two widths.  One width keeps its route."""
    want = "flash_sm90" if (dtype, hd, hdv) == (torch.bfloat16, 192, 128) \
        else "flash"
    assert tflash.design(dtype, hd, hdv) == want
    assert tflash.design(dtype, hd, hd) == tflash.design(dtype, hd)


def test_sm90_dispatch_instantiates_exactly_the_routed_pairs():
    """flash_sm90.cu's C entry accepts, and launches an instance for,
    exactly the (hd, hdv) pairs that ``design`` routes to it in bf16:
    no routed pair is refused on the card, and no instance is left
    without a route."""
    src = (_build.CSRC / "flash_sm90.cu").read_text()
    body = src[src.index('extern "C" int flash_sm90_fwd('):]
    accepted = {(int(a), int(b)) for a, b in re.findall(
        r"hd == (\d+) && hdv == (\d+)", body)}
    launched = {(int(a), int(b)) for a, b in re.findall(
        r"launch<(\d+), (\d+)>\(", body)}
    routed = set(tflash.SM90_HEAD_DIMS)
    assert accepted == launched == routed
    assert all(tflash.design(torch.bfloat16, *p) == "flash_sm90"
               for p in routed)
    assert all(tflash.design(torch.float32, *p) == "flash" for p in routed)
    # the dispatch picks the instance by hd alone: each q/k width has
    # one v width
    assert len({hd for hd, _ in routed}) == len(routed)


def test_launch_arguments_carry_v_width_after_hd():
    """Both C entries take hdv right after hd; the wrapper passes v's
    own width there and allocates out (B, Sq, H, hdv)."""
    for source, entry in (("flash", "flash_fwd"),
                          ("flash_sm90", "flash_sm90_fwd")):
        src = (_build.CSRC / f"{source}.cu").read_text()
        sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)',
                        src).group(1)
        params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
        assert params[params.index("hd") + 1] == "hdv"
        q = torch.zeros(1, 4, 2, 192, dtype=torch.bfloat16)
        v = torch.zeros(1, 4, 2, 128, dtype=torch.bfloat16)
        out = torch.empty(1, 4, 2, 128, dtype=torch.bfloat16)
        named = dict(zip(params, tflash.launch_args(
            q, q, v, out, causal=True, window=0, q_offset=0,
            source=source)))
        assert (named["hd"], named["hdv"]) == (192, 128)
        assert (named["v_sb"], named["v_ss"], named["v_sh"]) == (1024, 256,
                                                                 128)


def test_sm90_launch_arguments_fit_the_c_entry():
    """flash_sm90.cu's entry takes flash.cu's arguments without is_bf16:
    the wrapper's tuple for it fits its signature, in number and order."""
    src = (_build.CSRC / "flash_sm90.cu").read_text()
    sig = re.search(r'extern "C" int flash_sm90_fwd\(([^)]*)\)',
                    src).group(1)
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    ((name, argtypes),) = _build._SIGNATURES["flash_sm90"].items()
    assert name == "flash_sm90_fwd" and len(argtypes) == len(params)
    assert argtypes[-1] is ctypes.c_void_p and params[-1] == "stream"
    assert all(t is ctypes.c_void_p for t in argtypes[:4])
    assert all(t is ctypes.c_int64 for t in argtypes[4:-1])
    qkv = torch.zeros(2, 10, 8 + 2 + 2, 64, dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    out = torch.empty(2, 10, 8, 64, dtype=torch.bfloat16)
    args = tflash.launch_args(q, k, v, out, causal=True, window=3,
                              q_offset=5, source="flash_sm90")
    named = dict(zip(params, args))
    assert len(args) == len(params) - 1
    assert (named["q_sb"], named["q_ss"], named["q_sh"]) == (7680, 768, 64)
    assert (named["k_sb"], named["v_ss"], named["v_sh"]) == (7680, 768, 64)
    assert [named[n] for n in ("B", "Sq", "Sk", "H", "KVH", "hd", "causal",
                               "window", "q_offset")] == \
        [2, 10, 10, 8, 2, 64, 1, 3, 5]
    assert named["k"] == k.data_ptr() != q.data_ptr()
    # flash.cu's entry keeps its is_bf16 as the last argument
    assert tflash.launch_args(q, k, v, out, causal=True, window=3,
                              q_offset=5)[:-1] == args
