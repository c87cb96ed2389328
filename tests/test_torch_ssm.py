"""The port's Mamba2 / SSD block and the mamba2 smoke model against the
JAX package's, on the CPU.

Both packages run the reference's ``init_model(PRNGKey(0), cfg)``
weights, carried over by ``convert.lm_params_from_reference``; the
module tests draw the conv, ``dt_bias``, ``ssm_D`` and the gate norm
from numpy instead of the init's identity conv and constants, so that
every leaf moves the output.  Inputs come from numpy with a seed.  The
reference writes the SSD scan in ``jnp`` with no Pallas kernel; the
port runs it in PyTorch (``repro_torch/models/ssm.py``).

Tolerances (``test_torch_lm.py``'s):
* fp32: ``FP32_TOL`` (rtol 1e-4, atol 1e-5), the same float program up
  to summation order and the two libraries' exp and log1p;
* bf16: ``BF16_TOL`` (rtol/atol 0.08) with argmax agreement above 0.95
  where logits are compared; the conv's taps, the gate and the output
  projection round to bf16 in both, at places that may differ by an
  ulp;
* the conv's carry (the last W-1 inputs): equal exactly;
* serving: tokens equal exactly in fp32;
* decode against the port's own forward: fp32 at ``FP32_TOL``; bf16 at
  argmax agreement above 0.9, the reference's own test's bound
  (``tests/test_models.py::test_decode_matches_forward_ssm``: a bf16
  decode rounds its state to bf16 every step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm as lm
from repro.data.synthetic import TokenStream as JTokenStream
from repro.launch import serve as jserve
from repro.models import init_model as jinit
from repro.models import init_serve_cache as jcache, serve_step as jstep
from repro.models import ssm as jssm
from repro_torch.convert import reference_leaf
from repro_torch.data import TokenStream
from repro_torch.launch import serve as tserve
from repro_torch.models import (for_serving, forward, init_model,
                                init_serve_cache, serve_step)
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import Dense, RMSNorm, cdtype
from torch_threads import _one_thread  # noqa: F401 (autouse)

ARCH = "mamba2_130m"
DTYPES = lm.DTYPES


def _dt(dtype):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


def _mixer(dtype, seed=40):
    """Stacked layer 0's Mamba2 in both packages, with the conv,
    ``dt_bias``, ``ssm_D`` and the gate norm's scale drawn from numpy;
    the port's leaves held as a serving model holds them."""
    jc, tc, params, _ = lm._models(ARCH, dtype)
    jp = dict(lm._layer0(params)["mixer"])
    rng = np.random.default_rng(seed)
    for k in ("conv_w", "conv_b", "dt_bias", "ssm_D"):
        jp[k] = rng.normal(size=jp[k].shape).astype(np.float32) * 0.5
    jp["gate_norm"] = {"scale": 1.0 + 0.2 * rng.normal(
        size=jp["gate_norm"]["scale"].shape).astype(np.float32)}
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float32)), jp)

    def t(a, dt=_dt(dtype)):
        return torch.from_numpy(np.array(a, np.float32)).to(dt)

    f32 = torch.float32
    tp = tssm.Mamba2(Dense(t(jp["ssm_in"]["w"])), t(jp["conv_w"]),
                     t(jp["conv_b"]), t(jp["dt_bias"], f32),
                     t(jp["A_log"], f32), t(jp["ssm_D"], f32),
                     RMSNorm(t(jp["gate_norm"]["scale"], f32)),
                     Dense(t(jp["ssm_out"]["w"])))
    return jc, tc, jp, tp


def test_softplus_is_jax_softplus():
    """``logaddexp(x, 0)`` at every x, past F.softplus's threshold of 20
    too."""
    x = np.concatenate([np.linspace(-90, 90, 721, dtype=np.float32),
                        np.random.default_rng(41).normal(
                            size=200).astype(np.float32) * 30])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = tssm.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("carry", [False, True], ids=["zeros", "carry"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_matches_reference(dtype, carry):
    jx, tx = lm._x((2, 9, 40), dtype, seed=42)
    jw, tw = lm._x((4, 40), dtype, seed=43)
    jb, tb = lm._x((40,), dtype, seed=44)
    jprev = tprev = None
    if carry:
        jprev, tprev = lm._x((2, 3, 40), dtype, seed=45)
    want, want_prev = jssm._causal_conv(jx, jw, jb, jprev)
    got, prev = tssm._causal_conv(tx, tw, tb, tprev)
    assert got.dtype == tx.dtype and prev.dtype == tx.dtype
    lm._close(got, want, dtype)
    assert np.array_equal(lm._np(prev), lm._np(want_prev))


def _scan_inputs(S, seed):
    rng = np.random.default_rng(seed)
    H, P, N = 4, 8, 16
    x = rng.normal(size=(2, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(2, S, H)))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H, dtype=np.float32)
    Bm = rng.normal(size=(2, S, N)).astype(np.float32)
    Cm = rng.normal(size=(2, S, N)).astype(np.float32)
    s0 = rng.normal(size=(2, H, N, P)).astype(np.float32)
    return (x, dt, A, Bm, Cm), s0


@pytest.mark.parametrize("init", [False, True], ids=["zero-state", "state"])
@pytest.mark.parametrize("S,chunk", [(16, 16), (48, 16)],
                         ids=["one-chunk", "three-chunks"])
def test_ssd_chunked_matches_reference(S, chunk, init):
    args, s0 = _scan_inputs(S, seed=46 + S)
    kw_j = dict(init_state=jnp.asarray(s0)) if init else {}
    kw_t = dict(init_state=torch.from_numpy(s0)) if init else {}
    want, want_s = jssm._ssd_chunked(*map(jnp.asarray, args), chunk, **kw_j)
    got, s = tssm._ssd_chunked(*map(torch.from_numpy, args), chunk, **kw_t)
    assert got.dtype == torch.float32 and s.shape == (2, 4, 16, 8)
    lm._close(got, want, "float32")
    lm._close(s, want_s, "float32")


def test_ssd_chunked_is_the_recurrence():
    """The chunked scan against the plain recurrence s_t = exp(dt_t A) s
    + dt_t B_t x_t^T, y_t = C_t . s_t, in float64 numpy."""
    args, s0 = _scan_inputs(48, seed=47)
    x, dt, A, Bm, Cm = (a.astype(np.float64) for a in args)
    s = s0.astype(np.float64)
    ys = []
    for t in range(48):
        s = np.exp(dt[:, t] * A)[:, :, None, None] * s + np.einsum(
            "bh,bn,bhp->bhnp", dt[:, t], Bm[:, t], x[:, t])
        ys.append(np.einsum("bn,bhnp->bhp", Cm[:, t], s))
    got, final = tssm._ssd_chunked(*map(torch.from_numpy, args), 16,
                                   init_state=torch.from_numpy(s0))
    np.testing.assert_allclose(got.numpy(), np.stack(ys, 1), **lm.FP32_TOL)
    np.testing.assert_allclose(final.numpy(), s, **lm.FP32_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_mamba2_prefill_matches_reference(dtype):
    jc, tc, jp, tp = _mixer(dtype)
    jx, tx = lm._x((2, 64, jc.d_model), dtype, seed=48)     # two chunks
    want, jnew = jssm.apply_mamba2(jp, jc, jx)
    got, new = tssm.apply_mamba2(tp, tc, tx)
    assert jnew is None and new is None
    assert got.dtype == tx.dtype and got.shape == tx.shape
    lm._close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_mamba2_decode_matches_reference(dtype):
    """Three decode steps from a cache of numpy values; the state and the
    conv window stay in the compute dtype, written in place."""
    jc, tc, jp, tp = _mixer(dtype)
    jcache_ = jssm.init_mamba2_cache(jc, 2)
    tcache = tssm.init_mamba2_cache(tc, 2, device="cpu")
    for name in ("conv", "state"):
        j, t = lm._x(tuple(tcache[name].shape), dtype, seed=49 + len(name))
        jcache_[name], tcache[name] = j, t
    held = {k: v for k, v in tcache.items()}
    for step in range(3):
        jx, tx = lm._x((2, 1, jc.d_model), dtype, seed=51 + step)
        want, jcache_ = jssm.apply_mamba2(jp, jc, jx, cache=jcache_)
        got, tcache = tssm.apply_mamba2(tp, tc, tx, cache=tcache)
        lm._close(got, want, dtype)
        for name in ("conv", "state"):
            assert tcache[name] is held[name]
            assert tcache[name].dtype == cdtype(tc)
            lm._close(tcache[name], jcache_[name], dtype)
    with pytest.raises(ValueError, match="one position a step"):
        tssm.apply_mamba2(tp, tc, lm._x((2, 2, jc.d_model), dtype)[1],
                          cache=tcache)


def test_chunk_refusal_in_both_packages():
    """A sequence longer than the chunk and not a multiple of it: the
    reference's reshape fails, the port raises a ValueError naming the
    chunk; neither pads."""
    jc, tc, jp, tp = _mixer("float32")
    jx, tx = lm._x((1, 40, jc.d_model), "float32", seed=54)   # chunk 32
    with pytest.raises(TypeError):
        jssm.apply_mamba2(jp, jc, jx)
    with pytest.raises(ValueError, match="not a multiple of the chunk 32"):
        tssm.apply_mamba2(tp, tc, tx)


@pytest.mark.parametrize("train", [False, True], ids=["serve", "train"])
def test_init_model_holds_the_reference_leaves(train):
    """The port's own init: the reference's leaves and shapes, the
    projections normal * 1/sqrt(fan_in), the conv the identity on its
    last tap, A_log = log(1..16), D 1; ``dt_bias``, ``A_log`` and
    ``ssm_D`` fp32 in a serving model, as ``for_serving`` keeps them."""
    jc, tc = lm._cfgs(ARCH, "bfloat16")
    model = init_model(tc, seed=1, device="cpu", train=train)
    ref = jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                       jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0),
                                                    jc)))
    names = {n for n, _ in model.named_parameters()}
    assert {n for n in names if n.startswith("stack.0.")} == {
        f"stack.0.{k}" for k in (
            "norm1.scale", "mixer.ssm_in.w", "mixer.conv_w", "mixer.conv_b",
            "mixer.dt_bias", "mixer.A_log", "mixer.ssm_D",
            "mixer.gate_norm.scale", "mixer.ssm_out.w")}
    serving = for_serving(model) if train else model
    for name, p in serving.named_parameters():
        assert tuple(p.shape) == reference_leaf(ref, name, tc).shape, name
        fp32 = name.endswith((".scale", ".dt_bias", ".A_log", ".ssm_D"))
        assert p.dtype == (torch.float32 if fp32 else torch.bfloat16), name
    mix = model.stack[1].mixer
    assert torch.equal(mix.conv_w[-1].float(), torch.ones(mix.conv_w.shape[1]))
    assert not mix.conv_w[:-1].float().any() and not mix.conv_b.float().any()
    np.testing.assert_allclose(mix.A_log.detach().exp().numpy(),
                               np.linspace(1, 16, tc.ssm_heads), rtol=1e-6)
    assert torch.equal(mix.ssm_D, torch.ones_like(mix.ssm_D))
    std = float(mix.ssm_in.w.detach().float().std()) * np.sqrt(tc.d_model)
    assert abs(std - 1.0) < 0.05, std


@pytest.mark.parametrize("dtype", DTYPES)
def test_twelve_serve_steps_match_reference(dtype):
    """Twelve decode steps of 3 rows from zero caches: the logits, and
    every layer's conv window and SSD state after the last step."""
    jc, tc, params, model = lm._models(ARCH, dtype)
    toks = np.random.default_rng(55).integers(0, jc.vocab_size, (3, 12))
    jc_ = jcache(params, jc, 3, 16)
    tc_ = init_serve_cache(model, tc, 3, 16)
    got, want = [], []
    for t in range(12):
        jlg, jc_ = jstep(params, jc, jc_, jnp.asarray(toks[:, t:t + 1]))
        tlg, tc_ = serve_step(model, tc, tc_, toks[:, t:t + 1])
        got.append(lm._np(tlg))
        want.append(lm._np(jlg))
    lm._close(np.concatenate(got), np.concatenate(want), dtype, argmax=True)
    assert tc_["pos"] == int(jc_["pos"]) == 12
    for i, layer in enumerate(tc_["stack"]):
        assert set(layer["mixer"]) == {"conv", "state"}
        for name, x in layer["mixer"].items():
            assert x.dtype == cdtype(tc)
            lm._close(x, jc_["stack"]["l0"]["mixer"][name][i], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_forward_in_port(dtype):
    _, tc = lm._cfgs(ARCH, dtype)
    model = init_model(tc, seed=0, device="cpu")
    toks = np.random.default_rng(56).integers(0, tc.vocab_size, (2, 64))
    par, _ = forward(model, tc, {"tokens": toks})
    caches = init_serve_cache(model, tc, 2, 64)
    dec = []
    for t in range(64):
        lg, caches = serve_step(model, tc, caches, toks[:, t:t + 1])
        dec.append(lg[:, 0])
    dec, par = lm._np(torch.stack(dec, 1)), lm._np(par)
    if dtype == "float32":
        lm._close(dec, par, dtype, argmax=True)
    else:
        assert (dec.argmax(-1) == par.argmax(-1)).mean() > 0.9


def _serve(server, prompts, max_new):
    ids = [server.submit(p, max_new=max_new) for p in prompts]
    done = {r["id"]: r for r in server.run()}
    return [done[i]["generated"] for i in ids]


def test_generate_and_batched_server_match_reference():
    """fp32: ``generate`` and a ``BatchedServer`` of 5 requests through
    2 slots give the reference's tokens; prompts admitted into every
    slot at once give ``generate``'s tokens, to the bit."""
    jc, tc, params, model = lm._models(ARCH, "float32")
    prompts = JTokenStream(jc.vocab_size, 0).batch(0, 4, 7)[:, :7]
    assert np.array_equal(prompts, TokenStream(tc.vocab_size, 0)
                          .batch(0, 4, 7)[:, :7])
    with jax.threefry_partitionable(False):
        want = jserve.generate(jc, params, prompts, max_new=5)
        jsrv = jserve.BatchedServer(jc, params, slots=2, max_len=64)
        want_srv = _serve(jsrv, list(prompts) + [prompts[0][:4]], 4)
    got = tserve.generate(tc, model, prompts, max_new=5)
    assert np.array_equal(got, want)
    tsrv = tserve.BatchedServer(tc, model, slots=2, max_len=64)
    assert _serve(tsrv, list(prompts) + [prompts[0][:4]], 4) == want_srv
    together = tserve.BatchedServer(tc, model, slots=4, max_len=40)
    assert np.array_equal(np.asarray(_serve(together, list(prompts), 5)),
                          got[:, 7:])


def test_batched_server_carries_a_slot_state_into_its_next_request():
    """As the reference, ``BatchedServer`` resets nothing on admission:
    a request admitted into a slot that served before starts from the
    SSM state and conv window its predecessor left there.  Pinned three
    ways, in fp32: the second request's tokens are the reference
    server's; they are a replay through ``serve_step`` that carries the
    first request's caches on; and that replay's logits leave those of
    the same prompt from zero caches (the carry is seen)."""
    jc, tc, params, model = lm._models(ARCH, "float32")
    p1, p2 = JTokenStream(jc.vocab_size, 3).batch(0, 2, 6)[:, :6]
    with jax.threefry_partitionable(False):
        want = _serve(jserve.BatchedServer(jc, params, slots=1, max_len=64),
                      [p1, p2], 4)
    srv = tserve.BatchedServer(tc, model, slots=1, max_len=64)
    got = _serve(srv, [p1, p2], 4)
    assert got == want

    def replay(caches, feed):
        logits = []
        for tok in feed:
            lg, caches = serve_step(model, tc, caches, np.array([[tok]]))
            logits.append(lm._np(lg)[0, 0])
        return caches, np.stack(logits)

    caches, _ = replay(init_serve_cache(model, tc, 1, 64),
                       list(p1) + got[0][:-1])
    state = caches["stack"][0]["mixer"]["state"]
    assert float(state.abs().max()) > 0.0
    _, carried = replay(caches, list(p2) + got[1][:-1])
    assert list(carried[len(p2) - 1:].argmax(-1)) == got[1]
    _, fresh = replay(init_serve_cache(model, tc, 1, 64), list(p2))
    assert np.abs(carried[:len(p2)] - fresh).max() > 1e-3
