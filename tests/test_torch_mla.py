"""The port's MLA layer, its two-width attention, the deepseek smoke
model's caches and its training against the JAX package's, on the CPU.

Both packages run the reference's ``init_model(PRNGKey(0), cfg)``
weights, carried over by ``convert.lm_params_from_reference`` (with
``train=True``, fp32 masters with gradients); inputs come from numpy
with a seed.  On the CPU MLA's prefill attention runs the flash
kernel's plain version ``ref.attention_ref`` at two widths (q and k
nope + rope wide, v ``v_head_dim``), and its gradient the two-width
backward's plain version ``ref.attention_bwd_ref``, where the reference
runs ``chunked_attention`` under ``jax.grad``.

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
* training: the prefill's vjp in fp32 at ``FP32_TOL``; the smoke
  model's ``loss_fn`` and every gradient leaf at
  ``test_torch_train.py``'s tolerances (fp32 ``FP32_TOL``; bf16 the loss
  at ``BF16_LOSS_RTOL`` and each leaf at a relative Frobenius error of
  2^-4, but the leaves of a MoE layer whose bf16 routing flips at a
  router near-tie, held in fp32 only); remat on and off the same bits.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_flash as fl
import test_torch_lm as lm
import test_torch_moe as moe
import test_torch_train as train
from repro.kernels import ref as jref
from repro.models import init_serve_cache as jcache, loss_fn as jloss_fn
from repro.models import serve_step as jstep
from repro.models import mla as jmla
from repro.models.layers import chunked_attention
from repro_torch.convert import reference_leaf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import init_serve_cache, loss_fn, serve_step
from repro_torch.models import mla as tmla
from repro_torch.models.layers import cdtype
from torch_threads import _one_thread  # noqa: F401 (autouse)

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


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(dtype):
    """The reference's (loss, aux, grads as numpy) of the deepseek smoke
    model on ``test_torch_moe._batch`` (2 x 32 tokens: one group of the
    smoke config's ``router_group`` of 64), with its remat."""
    jc, tc = lm._cfgs(ARCH, dtype)
    params = train._reference_params(ARCH, dtype)
    jb = {k: jnp.asarray(v.numpy().astype(np.int32))
          for k, v in moe._batch(tc.vocab_size).items()}
    with jax.threefry_partitionable(False):
        (loss, met), grads = jax.jit(jax.value_and_grad(
            lambda p: jloss_fn(p, jc, jb, remat=True), has_aux=True))(params)
    return float(loss), float(met["aux"]), jax.tree.map(np.asarray, grads)


def _port_loss_and_grads(dtype, remat):
    model = train._port_model(ARCH, dtype)
    loss, met = loss_fn(model, model.cfg, moe._batch(model.cfg.vocab_size),
                        remat=remat)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return model, loss.detach(), {k: x.detach() for k, x in met.items()}, \
        dict(zip(named, grads))


def _flipped_layers(dtype):
    """The port's names (``stack.{j}``) of the MoE layers whose routing
    in the loss's forward differs between the packages, each flip held
    to its explanation (``test_torch_moe._flips``: a near-tie of the
    router's fp32 logits, or a later token of a group in which one
    flipped)."""
    jc, tc = lm._cfgs(ARCH, dtype)
    jb = {k: jnp.asarray(v.numpy().astype(np.int32))
          for k, v in moe._batch(tc.vocab_size).items()}
    with jax.threefry_partitionable(False), moe.reference_routing() as ref:
        jloss_fn(train._reference_params(ARCH, dtype), jc, jb, remat=False)
    model = train._port_model(ARCH, dtype)
    with moe.port_routing() as got, torch.no_grad():
        loss_fn(model, tc, moe._batch(tc.vocab_size), remat=False)
    n_pro = len(tc.prologue)
    assert len(got) == len(ref["dispatch"]) == tc.n_layers - n_pro
    flipped = []
    for j, (jd, r) in enumerate(zip(ref["dispatch"], got)):
        r = {k: x.detach() if torch.is_tensor(x) else x for k, x in r.items()}
        f, tie, cascade = moe._flips(jd, r, tc.top_k)
        assert (tie | cascade)[f].all(), (j, np.nonzero(f))
        if f.any():
            flipped.append(f"stack.{j}")
    return flipped


@pytest.mark.parametrize("dtype", DTYPES)
def test_deepseek_loss_and_gradients_match_reference(dtype):
    """The deepseek smoke model (a dense MLA prologue layer, two MLA+MoE
    layers) trains: its loss and every gradient leaf against
    ``jax.value_and_grad`` of the reference's ``loss_fn``.  fp32: the
    loss, the aux and every leaf at ``test_torch_train.py``'s
    ``FP32_TOL``; bf16: the loss at ``BF16_LOSS_RTOL`` and each leaf at a
    relative Frobenius error of 2^-4 (``test_torch_train.py`` says why),
    but in a MoE layer whose routing flips between the packages.  In
    bf16 the two packages' attention rounds at other places, and on this
    batch three tokens of the last MoE layer (``stack.1``) sit at
    near-ties of the router and go to other experts (or, after such a
    token, to other capacity slots); those experts then take the
    gradient of other tokens, a step of the function itself.  So that
    layer's routed leaves (the router, the routed experts and ``norm2``,
    whose gradient sums over them) are held in fp32 only, where the
    routing is the same bits; ``_flipped_layers`` finds the flips and
    holds each to its explanation."""
    model, loss, met, grads = _port_loss_and_grads(dtype, remat=True)
    want_loss, want_aux, want_grads = _reference_loss_and_grads(dtype)
    assert float(met["tokens"]) == 2 * 32 - 1 and float(met["aux"]) > 0.0
    names = {n for n, _ in model.named_parameters()}
    assert set(grads) == names
    for part in ("attn.wq.w", "attn.kv_a.w", "attn.kv_norm.scale",
                 "attn.kv_b.w", "attn.wo.w", "moe.router.w",
                 "moe.experts_in.w", "moe.shared_down.w"):
        assert f"stack.0.{part}" in names, part
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), want_loss, **train.FP32_TOL)
        np.testing.assert_allclose(float(met["aux"]), want_aux,
                                   rtol=moe.AUX_RTOL)
        held = names
    else:
        np.testing.assert_allclose(float(loss), want_loss,
                                   rtol=train.BF16_LOSS_RTOL)
        flipped = _flipped_layers(dtype)
        assert flipped == ["stack.1"], flipped
        routed = ("moe.router.", "moe.experts_", "norm2.")
        held = {n for n in names if not any(
            n.startswith(tuple(f"{lay}.{r}" for r in routed))
            for lay in flipped)}
        assert len(held) == len(names) - 5
    for name, g in grads.items():
        want = reference_leaf(want_grads, name, model.cfg).astype(np.float32)
        got = g.to(torch.float32).numpy()
        assert got.shape == want.shape and np.isfinite(got).all(), name
        if name not in held:
            continue
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **train.FP32_TOL,
                                       err_msg=name)
        else:
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= train.BF16_GRAD_REL, (name, rel)


@pytest.mark.parametrize("dtype", DTYPES)
def test_deepseek_remat_gives_the_same_gradient_bits(dtype):
    _, loss_a, _, ga = _port_loss_and_grads(dtype, remat=True)
    _, loss_b, _, gb = _port_loss_and_grads(dtype, remat=False)
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(ga[n], gb[n]) for n in ga)


def test_apply_mla_prefill_vjp_matches_reference():
    """The gradient of the decompressed prefill, in fp32, with respect to
    the input and each of the layer's leaves, against ``jax.vjp`` of the
    reference's ``apply_mla`` (which runs ``chunked_attention``): the
    port's goes through the two-width flash backward's plain version,
    q and k as ``torch.cat``s, v a strided view into the ``kv_b``
    product.  ``FP32_TOL``: the same function summed in another order."""
    jc, tc, jp, tp = _mla("float32")
    jx, tx = lm._x((2, 37, jc.d_model), "float32", seed=34)
    g = np.random.default_rng(35).normal(
        size=(2, 37, jc.d_model)).astype(np.float32)
    with jax.threefry_partitionable(False):
        _, vjp = jax.vjp(lambda p, x: jmla.apply_mla(p, jc, x)[0], jp, jx)
        want_p, want_x = vjp(jnp.asarray(g))
    named = dict(tp.named_parameters())
    leaves = [p.requires_grad_() for p in named.values()]
    x = tx.clone().requires_grad_()
    y, _ = tmla.apply_mla(tp, tc, x)
    got = torch.autograd.grad(y, [x] + leaves, torch.from_numpy(g))
    assert set(named) == {"wq.w", "kv_a.w", "kv_norm.scale", "kv_b.w",
                          "wo.w"}
    lm._close(got[0], want_x, "float32")
    for (name, _), gl in zip(named.items(), got[1:]):
        a, b = name.split(".")
        lm._close(gl, want_p[a][b], "float32")
