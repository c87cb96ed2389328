"""The port's Jamba hybrid period (Mamba2, attention with its sliding
window, MoE) against the JAX package's, on the CPU.

Both packages run the reference's ``init_model(PRNGKey(0), cfg)``
weights of the jamba smoke config (one period of 8 layers: attention
at index 3, Mamba2 elsewhere, MoE on the odd layers), carried over by
``convert.lm_params_from_reference``; inputs come from numpy with a
seed.  ``config(long_context=True)`` gives the attention layers a
window; the smoke tests cut it to 8 positions (``_windowed``), so that
a prefill of 32 tokens is cut by it and a decode wraps its ring buffer
of 8 rows several times.

Tolerances:
* one attention layer, and the windowed cache: ``test_torch_lm.py``'s
  ``FP32_TOL`` / ``BF16_TOL``;
* whole models in fp32: rtol 1e-4 with atol at ``SCALED_ATOL`` (1e-4)
  of the largest |value| (``test_torch_lm.py`` says why and what was
  seen), argmax agreement above 0.999, every MoE dispatch equal
  exactly; tokens of ``generate`` and ``BatchedServer`` equal exactly;
* whole models in bf16: the routing flips as ``test_torch_moe.py``
  holds them (``_unreached``: each a near-tie of the router, or a later
  token of its group).  On the rows no flip reached, an elementwise
  bf16 tolerance does not hold here: through eight layers the
  reference's own bf16 logits leave its fp32 ones by up to 0.55 (a
  relative Frobenius error of 0.044 to 0.051).  So the port's bf16
  logits are held to the reference's fp32 logits as closely as the
  reference's bf16 logits are, within 1.25 times their relative
  Frobenius error (seen: 0.94 to 0.98 times), and agree in argmax with
  them no less than 0.05 below the reference's bf16 share;
* serving (decode past the wrap, ``generate``, ``BatchedServer``):
  ``test_torch_jamba_serve.py``; training: ``test_torch_jamba_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_lm as lm
import test_torch_moe as moe
import test_torch_train as train
from repro.models import forward as jforward
from repro.models import layers as jL
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import forward
from repro_torch.models import layers as tL
from torch_threads import _one_thread  # noqa: F401 (autouse)

ARCH = "jamba_v01_52b"
DTYPES = lm.DTYPES
WINDOW = 8
ATTN = 3                    # the period's attention layer
BF16_REL = 1.25             # bf16 against the reference's own bf16 error


def _windowed(cfg, window):
    return dataclasses.replace(cfg, pattern=tuple(
        dataclasses.replace(s, window=window if s.mixer == "attn" else 0)
        for s in cfg.pattern))


def _models(dtype, window=WINDOW, train_=False, **changes):
    """Both cfgs (the attention layers' window set to ``window``), the
    reference's params and the port's model of them."""
    jc, tc = lm._cfgs(ARCH, dtype)
    jc = dataclasses.replace(_windowed(jc, window), **changes)
    tc = dataclasses.replace(_windowed(tc, window), **changes)
    params = train._reference_params(ARCH, dtype)
    model = lm_params_from_reference(jax.tree.map(np.asarray, params), tc,
                                     device="cpu", train=train_)
    return jc, tc, params, model


def _close(got, want, argmax=False):
    """fp32, whole models: rtol 1e-4, atol at ``SCALED_ATOL`` of the
    largest |value|."""
    lm._close(got, want, "float32", argmax=argmax, scaled=True)


def test_ring_buffer_size():
    """``min(window, max_len)`` rows in both packages; no window: all."""
    jc, tc = lm._cfgs(ARCH, "float32")
    for window, max_len, rows in ((8, 32, 8), (64, 32, 32), (0, 32, 32)):
        want = jL.init_attn_cache(jc, 2, max_len, window)
        got = tL.init_attn_cache(tc, 2, max_len, window, device="cpu")
        assert tuple(got["k"].shape) == want["k"].shape \
            == (2, rows, tc.n_kv_heads, tc.head_dim)
        assert got["len"] == int(want["len"]) == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_windowed_attention_layer_matches_reference(dtype):
    """The period's attention layer with a window of 8: a prefill of 20
    positions (the window cuts it), then 20 decode steps from an empty
    ring buffer of 8 rows, which wraps twice; each step's output and
    the buffer against the reference's."""
    jc, tc, params, model = _models(dtype)
    jp = jax.tree.map(lambda a: a[0], params["stack"][f"l{ATTN}"]["attn"])
    tp = model.stack[ATTN].attn
    assert model.stack[ATTN].window == WINDOW
    jx, tx = lm._x((2, 20, jc.d_model), dtype, seed=60)
    want, _ = jL.apply_attention(jp, jc, jx, window=WINDOW)
    got, _ = tL.apply_attention(tp, tc, tx, window=WINDOW)
    lm._close(got, want, dtype)
    # the same prefill without the window differs: it is cut
    assert np.abs(lm._np(tL.apply_attention(tp, tc, tx)[0])
                  - lm._np(got)).max() > 1e-2
    jcache_ = jL.init_attn_cache(jc, 2, 32, WINDOW)
    tcache = tL.init_attn_cache(tc, 2, 32, WINDOW, device="cpu")
    for t in range(20):
        jx1, tx1 = lm._x((2, 1, jc.d_model), dtype, seed=61 + t)
        want, jcache_ = jL.apply_attention(jp, jc, jx1, window=WINDOW,
                                           cache=jcache_)
        got, tcache = tL.apply_attention(tp, tc, tx1, window=WINDOW,
                                         cache=tcache)
        lm._close(got, want, dtype)
        assert tcache["len"] == int(jcache_["len"]) == t + 1
        for name in ("k", "v"):
            lm._close(tcache[name], jcache_[name], dtype)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("window", [0, WINDOW], ids=["full", "window8"])
def test_forward_bf16_matches_reference(window):
    """bf16 over B x S = 2 x 64 (two chunks of the scan, two router
    groups): every routing flip explained, and on the rows no flip
    reached the port's logits as close to the reference's fp32 logits
    as the reference's bf16 logits are (the module docstring says
    why)."""
    jc, tc, params, model = _models("bfloat16", window)
    jc32 = dataclasses.replace(jc, dtype="float32")
    B, S = 2, 64
    toks = np.random.default_rng(62).integers(0, jc.vocab_size, (B, S))
    jb = {"tokens": jnp.asarray(toks)}
    with moe.reference_routing() as ref:
        want, jaux = jforward(params, jc, jb, remat=False)
    with moe.port_routing() as got_r:
        got, aux = forward(model, tc, {"tokens": toks})
    want32, _ = jforward(params, jc32, jb, remat=False)
    got, want, want32 = lm._np(got), lm._np(want), lm._np(want32)
    assert np.isfinite(got).all() and float(aux) > 0.0
    assert len(got_r) == len(ref["dispatch"]) == moe._n_moe(tc) == 4
    t = np.arange(B * S)
    n_flips, keep = moe._unreached(ref["dispatch"], got_r,
                                   [(t // S, t % S)] * len(got_r), tc.top_k,
                                   (B, S))
    assert n_flips <= 0.05 * B * S * len(got_r), n_flips
    assert keep.sum() >= B * S // 8, keep.sum()
    got, want, want32 = got[keep], want[keep], want32[keep]
    assert _rel(got, want32) <= BF16_REL * _rel(want, want32), (
        _rel(got, want32), _rel(want, want32))
    top = want32.argmax(-1)
    assert (got.argmax(-1) == top).mean() >= \
        (want.argmax(-1) == top).mean() - 0.05


def test_windowed_forward_matches_reference():
    """fp32, window 8, S = 32 (one chunk of the scan, 4 windows): logits,
    aux and every MoE dispatch."""
    jc, tc, params, model = _models("float32")
    toks = np.random.default_rng(63).integers(0, jc.vocab_size, (2, 32))
    with moe.reference_routing() as ref:
        want, jaux = jforward(params, jc, {"tokens": jnp.asarray(toks)},
                              remat=False)
    with moe.port_routing() as got_r:
        got, aux = forward(model, tc, {"tokens": toks})
    _close(got, want, argmax=True)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=moe.AUX_RTOL)
    for r, jd in zip(got_r, ref["dispatch"]):
        assert np.array_equal(r["dispatch"].numpy(), jd)
