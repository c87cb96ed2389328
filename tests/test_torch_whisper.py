"""Whisper's blocks and serving path in the port against the JAX
package's, on the CPU.

The whisper smoke model (2 encoder + 2 decoder layers, d 64, 4 heads of
16, LayerNorm, the GELU MLP with biases, sinusoidal positions, a cross
block in every decoder layer) starts from the reference's
``init_model(PRNGKey(0), cfg)`` weights (``test_torch_lm._models``);
inputs come from numpy with a seed.  On the CPU the port's attention
runs the flash kernel's plain version (``ref.attention_ref``): without
a causal mask in the encoder and in the cross blocks, where the
reference runs ``chunked_attention(causal=False)``.

Tolerances (``test_torch_lm.py``'s): fp32 rtol 1e-4, atol 1e-5 (the
same float program up to summation order); bf16 rtol/atol 0.08 with
argmax agreement above 0.95 (both packages round each projection, norm
and activation to bf16, at places that differ by an ulp).
``sinusoid_pos`` and ``for_serving`` are held bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm as lm
from repro.models import init_serve_cache as jcache
from repro.models import layers as jL
from repro.models import serve_step as jstep
from repro.models.transformer import encode as jencode
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve as tserve
from repro_torch.models import (encode, for_serving, forward,
                                init_serve_cache, serve_step)
from repro_torch.models import layers as tL
from torch_threads import _one_thread  # noqa: F401 (autouse)

ARCH = "whisper_medium"
DTYPES = lm.DTYPES


def _frames(cfg, B, seed=20):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)


def _t(x, dtype):
    """A reference array as a port tensor in ``dtype``'s compute dtype."""
    return torch.tensor(lm._np(x)).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_matches_reference(dtype):
    jx, tx = lm._x((2, 5, 64), dtype)
    rng = np.random.default_rng(21)
    scale, bias = (rng.normal(size=(64,)).astype(np.float32)
                   for _ in range(2))
    want = jL.layer_norm({"scale": jnp.asarray(scale),
                          "bias": jnp.asarray(bias)}, jx, 1e-5)
    got = tL.layer_norm(tL.LayerNorm(torch.from_numpy(scale),
                                     torch.from_numpy(bias)), tx, 1e-5)
    assert got.dtype == tx.dtype
    lm._close(got, want, dtype)


@pytest.mark.parametrize("d,seq", [(64, 4096), (1024, 448)],
                         ids=["smoke", "whisper-medium"])
def test_sinusoid_pos_is_the_reference_bits(d, seq):
    """The table bitwise, and a decode step's one row at position 447
    bitwise the table's row."""
    want = np.asarray(jL.sinusoid_pos(seq, d))
    got = tL.sinusoid_pos(seq, d)
    assert got.dtype == torch.float32 and got.shape == (seq, d)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    row = tL.sinusoid_pos(1, d, 447)
    assert np.array_equal(row.numpy()[0].view(np.uint32),
                          want[447].view(np.uint32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_mlp_matches_reference(dtype):
    """Decoder layer 0's GELU MLP, with nonzero biases so that they are
    held too (``approximate="tanh"`` is ``jax.nn.gelu``'s default)."""
    jc, tc, params, _ = lm._models(ARCH, dtype)
    rng = np.random.default_rng(22)
    jp = jax.tree.map(lambda a: jnp.asarray(
        a if a.ndim > 1 else rng.normal(size=a.shape).astype(np.float32)),
        lm._layer0(params)["mlp"])
    dt = tL.cdtype(tc)
    tp = tL.MLP(*(tL.Dense(torch.tensor(np.asarray(jp[k]["w"])).to(dt),
                           torch.tensor(np.asarray(jp[k]["bias"])).to(dt))
                  for k in ("wi", "wdown")))
    jx, tx = lm._x((2, 6, jc.d_model), dtype, seed=23)
    lm._close(tL.apply_mlp(tp, tc, tx), jL.apply_mlp(jp, jc, jx), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["encoder", "cross", "decoder"])
def test_apply_attention_modes_match_reference(mode, dtype):
    """Encoder layer 0's bidirectional self-attention without RoPE;
    decoder layer 0's cross block over 32 encoder rows (``kv_src=``,
    Sq 6 != Sk 32); decoder layer 0's causal self-attention without
    RoPE, in a prefill and in one decode step against a cache of 9
    rows."""
    jc, tc, params, model = lm._models(ARCH, dtype)
    jx, tx = lm._x((2, 6, jc.d_model), dtype, seed=24)
    if mode == "encoder":
        jp = jax.tree.map(lambda a: a[0],
                          params["encoder"]["stack"]["l0"])["attn"]
        want, _ = jL.apply_attention(jp, jc, jx, causal=False,
                                     use_rope=False)
        got, _ = tL.apply_attention(model.encoder.stack[0].attn, tc, tx,
                                    causal=False, use_rope=False)
        lm._close(got, want, dtype)
        return
    if mode == "cross":
        jenc, tenc = lm._x((2, 32, jc.d_model), dtype, seed=25)
        want, _ = jL.apply_attention(lm._layer0(params)["cross"], jc, jx,
                                     causal=False, kv_src=jenc,
                                     use_rope=False)
        got, _ = tL.apply_attention(model.stack[0].cross, tc, tx,
                                    causal=False, kv_src=tenc,
                                    use_rope=False)
        lm._close(got, want, dtype)
        return
    jp, tp = lm._layer0(params)["attn"], model.stack[0].attn
    want, _ = jL.apply_attention(jp, jc, jx, use_rope=False)
    got, _ = tL.apply_attention(tp, tc, tx, use_rope=False)
    lm._close(got, want, dtype)
    jc_ = jL.init_attn_cache(jc, 2, 16)
    tc_ = tL.init_attn_cache(tc, 2, 16, device="cpu")
    kv = np.random.default_rng(26).normal(
        size=(2, 2, 9, jc.n_kv_heads, jc.head_dim)).astype(np.float32)
    jc_["k"] = jc_["k"].at[:, :9].set(kv[0].astype(jc_["k"].dtype))
    jc_["v"] = jc_["v"].at[:, :9].set(kv[1].astype(jc_["v"].dtype))
    jc_["len"] = jnp.asarray(9, jnp.int32)
    tc_["k"][:, :9] = torch.from_numpy(kv[0])
    tc_["v"][:, :9] = torch.from_numpy(kv[1])
    tc_["len"] = 9
    jx1, tx1 = lm._x((2, 1, jc.d_model), dtype, seed=27)
    want, jnew = jL.apply_attention(jp, jc, jx1, cache=jc_, use_rope=False)
    got, tnew = tL.apply_attention(tp, tc, tx1, cache=tc_, use_rope=False)
    lm._close(got, want, dtype)
    lm._close(tnew["k"], jnew["k"], dtype)
    lm._close(tnew["v"], jnew["v"], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_reference(dtype):
    jc, tc, params, model = lm._models(ARCH, dtype)
    frames = _frames(jc, 2)
    want = jencode(params, jc, jnp.asarray(frames))
    got = encode(model, tc, frames)
    assert got.dtype == tL.cdtype(tc) and got.shape == frames.shape
    lm._close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_twelve_serve_steps_match_reference(dtype):
    """``init_serve_cache(enc_out=)``'s cross K/V (``stack_cross``) and
    12 decode steps of 2 rows, both packages from the reference's
    encoder output: the logits (argmax over all 24 rows), every layer's
    self-attention cache and the cross K/V after the last step."""
    jc, tc, params, model = lm._models(ARCH, dtype)
    enc = jencode(params, jc, jnp.asarray(_frames(jc, 2)))
    jc_ = jcache(params, jc, 2, 16, enc_out=enc)
    tc_ = init_serve_cache(model, tc, 2, 16, enc_out=_t(enc, dtype))
    assert len(tc_["stack_cross"]) == len(tc_["stack"]) == jc.n_layers
    for i, ck in enumerate(tc_["stack_cross"]):
        for name in ("k", "v"):
            want = jc_["stack_cross"]["l0"][name][i]
            assert tuple(ck[name].shape) == want.shape
            lm._close(ck[name], want, dtype)
    toks = np.random.default_rng(28).integers(0, jc.vocab_size, (2, 12))
    step = jax.jit(lambda p, c, x: jstep(p, jc, c, x))
    got, want = [], []
    for t in range(12):
        jlg, jc_ = step(params, jc_, jnp.asarray(toks[:, t:t + 1]))
        tlg, tc_ = serve_step(model, tc, tc_, toks[:, t:t + 1])
        got.append(lm._np(tlg))
        want.append(lm._np(jlg))
    lm._close(np.concatenate(got), np.concatenate(want), dtype, argmax=True)
    assert tc_["pos"] == int(jc_["pos"]) == 12
    for i, layer in enumerate(tc_["stack"]):
        for name, t in layer["mixer"].items():
            lm._close(t, jc_["stack"]["l0"]["mixer"][name][i], dtype)
        for name in ("k", "v"):
            lm._close(tc_["stack_cross"][i][name],
                      jc_["stack_cross"]["l0"][name][i], dtype)


@pytest.mark.parametrize("past", [-1, 0, 5], ids=["last_row", "at_max",
                                                  "past_max"])
def test_decode_step_past_max_seq_len_matches_reference(past):
    """One fp32 decode step at ``pos = max_seq_len + past`` from caches
    that ``init_serve_cache(..., prefilled=pos)`` builds in both packages
    (a 16-row self-attention cache, whose write both clamp to its last
    row, and the reference's encoder output as the cross K/V), held at
    ``FP32_TOL``.  The reference slices its ``max_seq_len``-row sinusoid
    table with ``dynamic_slice_in_dim``, which clamps the start: from
    ``max_seq_len`` on, every step adds the table's last row, and so
    does the port.  The reference's ``forward`` does not clamp: it
    builds ``sinusoid_pos(x.shape[1], ...)`` rows, so past
    ``max_seq_len`` decode and forward differ in both packages."""
    jc, tc, params, model = lm._models(ARCH, "float32")
    pos = jc.max_seq_len + past
    enc = jencode(params, jc, jnp.asarray(_frames(jc, 2)))
    jc_ = jcache(params, jc, 2, 16, enc_out=enc, prefilled=pos)
    tc_ = init_serve_cache(model, tc, 2, 16, enc_out=_t(enc, "float32"),
                           prefilled=pos)
    toks = np.random.default_rng(33).integers(0, jc.vocab_size, (2, 1))
    want, jc_ = jstep(params, jc, jc_, jnp.asarray(toks))
    got, tc_ = serve_step(model, tc, tc_, toks)
    lm._close(got, want, "float32", argmax=True)
    assert tc_["pos"] == int(jc_["pos"]) == pos + 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_forward_in_port(dtype):
    """``encode`` -> ``init_serve_cache(enc_out=)`` -> 12 ``serve_step``s
    give the logits of one ``forward`` over the same tokens and frames:
    fp32 at ``FP32_TOL``, bf16 at ``tests/test_models.py``'s tolerance."""
    _, tc, _, model = lm._models(ARCH, dtype)
    frames = _frames(tc, 2, seed=29)
    toks = np.random.default_rng(30).integers(0, tc.vocab_size, (2, 12))
    par, _ = forward(model, tc, {"tokens": toks, "enc_frames": frames})
    caches = init_serve_cache(model, tc, 2, 16,
                              enc_out=encode(model, tc, frames))
    dec = []
    for t in range(12):
        lg, caches = serve_step(model, tc, caches, toks[:, t:t + 1])
        dec.append(lg[:, 0])
    lm._close(torch.stack(dec, 1), par, dtype, argmax=True)


def test_encoder_decoder_serving_refusals():
    """The reference cannot serve an encoder-decoder model through
    ``generate`` (its forward needs ``enc_frames``) or ``BatchedServer``
    (its caches hold no cross K/V, so a cross block attends the step's
    token to itself); the port raises ValueError naming the route, and
    so does ``serve_step`` on caches without ``stack_cross``."""
    _, tc, _, model = lm._models(ARCH, "float32")
    route = r"encode -> init_serve_cache\(enc_out=\) -> serve_step"
    prompts = np.zeros((2, 4), np.int32)
    with pytest.raises(ValueError, match=route):
        tserve.generate(tc, model, prompts, max_new=2)
    with pytest.raises(ValueError, match=route):
        tserve.BatchedServer(tc, model, slots=2, max_len=16)
    caches = init_serve_cache(model, tc, 2, 16)
    assert "stack_cross" not in caches
    with pytest.raises(ValueError, match=route):
        serve_step(model, tc, caches, prompts[:, :1])


def test_for_serving_keeps_layernorm_biases_fp32_bitwise():
    """``for_serving`` of a bf16 training model (fp32 masters) holds the
    bits and dtypes of the serving model converted from the same
    weights: projections and their biases bf16, LayerNorm scales and
    biases fp32 (the reference adds the fp32 bias before its cast).
    The norms' scales and biases and the projections' biases are drawn
    away from 1 and 0, so that a bias cast to bf16 moves the logits."""
    jc, tc = lm._cfgs(ARCH, "bfloat16")
    with jax.threefry_partitionable(False):
        params = lm.jinit(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(31)
    tree = jax.tree.map(
        lambda a: np.asarray(a) if a.ndim > 1 else
        (np.asarray(a) + rng.normal(size=a.shape) * 0.1).astype(np.float32),
        params)
    serving = lm_params_from_reference(tree, tc, device="cpu")
    got = for_serving(lm_params_from_reference(tree, tc, device="cpu",
                                               train=True))
    want = dict(serving.named_parameters())
    assert set(dict(got.named_parameters())) == set(want)
    for name, p in got.named_parameters():
        assert p.dtype == want[name].dtype and torch.equal(p, want[name]), \
            name
        assert not p.requires_grad
    assert got.stack[0].norm_cross.bias.dtype == torch.float32
    assert got.encoder.final_norm.bias.dtype == torch.float32
    assert got.stack[0].cross.wq.w.dtype == torch.bfloat16
    batch = {"tokens": np.random.default_rng(32).integers(
        0, tc.vocab_size, (2, 8)), "enc_frames": _frames(tc, 2)}
    assert torch.equal(forward(got, tc, batch)[0],
                       forward(serving, tc, batch)[0])
