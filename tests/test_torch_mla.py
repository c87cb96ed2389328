"""The port's MLA layer, its two-width attention and the deepseek smoke
model's caches against the JAX package's, on the CPU.

Both packages run the reference's ``init_model(PRNGKey(0), cfg)``
weights, carried over by ``convert.lm_params_from_reference``; inputs
come from numpy with a seed.  On the CPU MLA's prefill attention runs
the flash kernel's plain version ``ref.attention_ref`` at two widths
(q and k nope + rope wide, v ``v_head_dim``), where the reference runs
``chunked_attention``.

Tolerances:
* ``apply_mla``, prefill and absorbed decode: ``test_torch_lm.py``'s
  ``FP32_TOL`` / ``BF16_TOL`` (the same float program up to summation
  order in fp32; bf16 roundings at places that differ by an ulp), the
  caches likewise;
* two-width attention, fp32: rtol 1e-5, atol 1e-6 against
  ``chunked_attention`` and the reference's ``ref.attention_ref``;
  bf16 against ``ref.attention_ref``: one bf16 ulp, as
  ``test_torch_flash.py`` holds one width (both keep the softmax in
  fp32 and round the output once);
* an MLA model asked to train raises ``NotImplementedError`` naming
  ROADMAP, and so does the attention gradient at two widths: nothing
  falls back to a plain gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_flash as fl
import test_torch_lm as lm
from repro.kernels import ref as jref
from repro.models import init_serve_cache as jcache, serve_step as jstep
from repro.models import mla as jmla
from repro.models.layers import chunked_attention
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import (init_model, init_serve_cache, loss_fn,
                                serve_step)
from repro_torch.models import mla as tmla
from repro_torch.models.layers import attention_fn, cdtype

ARCH = "deepseek_v2_lite_16b"
DTYPES = lm.DTYPES


def _mla(dtype):
    """The prologue layer's MLA in both packages, and both cfgs."""
    jc, tc, params, model = lm._models(ARCH, dtype)
    return jc, tc, params["pro0"]["attn"], model.pro[0].attn


def _caches(jc, tc, B, max_len, filled, seed):
    """The reference's and the port's MLA caches of ``max_len`` rows,
    the first ``filled`` from numpy, ``len`` = filled."""
    rng = np.random.default_rng(seed)
    ckv = rng.normal(size=(B, filled, jc.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(B, filled, jc.qk_rope_dim)).astype(np.float32)
    jcache_ = jmla.init_mla_cache(jc, B, max_len)
    jcache_["c_kv"] = jcache_["c_kv"].at[:, :filled].set(
        ckv.astype(jcache_["c_kv"].dtype))
    jcache_["k_rope"] = jcache_["k_rope"].at[:, :filled].set(
        kr.astype(jcache_["k_rope"].dtype))
    jcache_["len"] = jnp.asarray(filled, jnp.int32)
    tcache = tmla.init_mla_cache(tc, B, max_len, device="cpu")
    tcache["c_kv"][:, :filled] = torch.from_numpy(ckv)
    tcache["k_rope"][:, :filled] = torch.from_numpy(kr)
    tcache["len"] = filled
    return jcache_, tcache


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_mla_prefill_matches_reference(dtype):
    jc, tc, jp, tp = _mla(dtype)
    jx, tx = lm._x((2, 37, jc.d_model), dtype, seed=30)
    want, jnew = jmla.apply_mla(jp, jc, jx)
    got, new = tmla.apply_mla(tp, tc, tx)
    assert jnew is None and new is None
    assert got.dtype == tx.dtype and got.shape == tx.shape
    lm._close(got, want, dtype)


# (cache rows, rows filled, decode steps): steps inside the cache, and
# steps past its end, where both packages overwrite the last row
DECODE_CASES = [(16, 9, 4), (10, 9, 3)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("max_len,filled,steps", DECODE_CASES,
                         ids=["inside", "past the end"])
def test_apply_mla_absorbed_decode_matches_reference(max_len, filled, steps,
                                                     dtype):
    jc, tc, jp, tp = _mla(dtype)
    jcache_, tcache = _caches(jc, tc, 2, max_len, filled, seed=31)
    for t in range(steps):
        jx, tx = lm._x((2, 1, jc.d_model), dtype, seed=32 + t)
        want, jcache_ = jmla.apply_mla(jp, jc, jx, cache=jcache_)
        got, tcache = tmla.apply_mla(tp, tc, tx, cache=tcache)
        lm._close(got, want, dtype)
        assert tcache["len"] == int(jcache_["len"]) == filled + t + 1
        for name in ("c_kv", "k_rope"):
            assert tcache[name].dtype == cdtype(tc)
            lm._close(tcache[name], jcache_[name], dtype)


# (q shape, k shape, v width, masking): MLA's layout (H = KVH, q/k
# nope + rope wide against a narrower v), GQA at two widths, an offset
# with a window, a v wider than q and k
TWO_WIDTH = [
    ((2, 40, 4, 24), (2, 40, 4, 24), 16, dict(causal=True)),
    ((1, 70, 6, 48), (1, 70, 2, 48), 32, dict(causal=True)),
    ((2, 33, 4, 40), (2, 90, 2, 40), 24,
     dict(causal=True, window=30, q_offset=57)),
    ((1, 20, 2, 16), (1, 25, 1, 16), 32, dict(causal=False)),
]


def _two_width(q_shape, kv_shape, dv, seed):
    rng = np.random.default_rng(seed)
    v_shape = kv_shape[:3] + (dv,)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in (q_shape, kv_shape, v_shape))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q_shape,kv_shape,dv,kw", TWO_WIDTH,
                         ids=[f"{q}-{kv}-v{dv}" for q, kv, dv, _ in TWO_WIDTH])
def test_two_width_attention_matches_reference(q_shape, kv_shape, dv, kw,
                                               dtype):
    q, k, v = _two_width(q_shape, kv_shape, dv, seed=sum(q_shape) + dv)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    got = fl._port(q, k, v, tdt, **kw)
    assert got.shape == q_shape[:3] + (dv,)
    fl._close(got, fl._jax(jref.attention_ref, q, k, v, jdt, **kw), dtype)
    if dtype == "float32":
        fl._close(got, fl._jax(chunked_attention, q, k, v, jdt, **kw),
                  dtype)
    t = [torch.from_numpy(x).to(tdt) for x in (q, k, v)]
    direct = tref.attention_ref(*t, **kw)
    assert torch.equal(direct, tops.flash_attention(*t, **kw))
    out, lse = tref.attention_ref(*t, **kw, return_lse=True)
    assert torch.equal(out, direct) and lse.shape == (q_shape[0],
                                                      q_shape[2],
                                                      q_shape[1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_serve_caches_match_reference(dtype):
    """Every layer's MLA cache holds ``c_kv`` and ``k_rope`` rows in the
    compute dtype, the reference's values after five decode steps."""
    jc, tc, params, model = lm._models(ARCH, dtype)
    toks = np.random.default_rng(33).integers(0, jc.vocab_size, (3, 5))
    jc_ = jcache(params, jc, 3, 8)
    tc_ = init_serve_cache(model, tc, 3, 8)
    for t in range(5):
        _, jc_ = jstep(params, jc, jc_, jnp.asarray(toks[:, t:t + 1]))
        _, tc_ = serve_step(model, tc, tc_, toks[:, t:t + 1])
    want = {"c_kv": (3, 8, tc.kv_lora_rank), "k_rope": (3, 8, tc.qk_rope_dim)}
    layers = [(c, jc_["pro"][0]) for c in tc_["pro"]] + [
        (c, jax.tree.map(lambda a, i=i: a[i], jc_["stack"]["l0"]))
        for i, c in enumerate(tc_["stack"])]
    assert len(layers) == tc.n_layers
    for c, jl in layers:
        assert {k: tuple(x.shape) for k, x in c["mixer"].items()} == want
        for name in want:
            # rows past the fifth are zeros in both
            lm._close(c["mixer"][name], jl["mixer"][name], dtype)


def test_mla_training_raises_naming_roadmap():
    """On the CPU as on the card (the check runs before any device
    work): building, converting or taking the loss of an MLA model to
    train raises; the attention gradient at two widths raises too."""
    jc, tc, params, model = lm._models(ARCH, "float32")
    with pytest.raises(NotImplementedError, match="ROADMAP A10.3"):
        init_model(tc, device="cpu", train=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A10.3"):
        lm_params_from_reference(jax.tree.map(np.asarray, params), tc,
                                 device="cpu", train=True)
    toks = np.zeros((1, 8), np.int64)
    with pytest.raises(NotImplementedError, match="ROADMAP A10.3"):
        loss_fn(model, tc, {"tokens": toks, "labels": toks})
    q, k, v = (torch.randn(1, 8, 2, w, requires_grad=True)
               for w in (24, 24, 16))
    out = attention_fn(q, k, v, causal=True)
    assert out.shape == (1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP B4"):
        out.sum().backward()
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP B4"):
        tops.flash_attention_bwd(q, k, v, out, lse, out, causal=True)
