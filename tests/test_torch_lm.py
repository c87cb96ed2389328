"""The port's dense-decoder LM against the JAX package's, on the CPU.

Both packages run the same weights: the reference's
``init_model(PRNGKey(0), cfg)`` params, carried into the port by
``convert.lm_params_from_reference``; inputs come from numpy with a
seed.  On the CPU the port's attention runs the plain version of the
flash kernel (``ref.attention_ref``), where the reference's model runs
``chunked_attention``; both compute the same function.

Tolerances:
* fp32 (``dtype="float32"``): the same float program up to summation
  order (XLA's and PyTorch's CPU matmuls, softmax and rsqrt), rtol 1e-4
  with atol 1e-5 for values near 0;
* bf16 (the configs' own dtype): both packages round every projection,
  norm and activation to bf16, at places that differ by an ulp (XLA
  may keep an fp32 intermediate that PyTorch rounds, and the kernel's
  plain version keeps the softmax weights in fp32 where the reference
  rounds them to bf16), so the tolerance is the one
  ``tests/test_models.py`` holds decode against forward to: rtol/atol
  0.08, and argmax agreement above 0.95;
* configs and ``param_count``: exactly equal.

Whisper's and InternVL2's forward take their stub inputs
(``_stubs``: encoder frames, patch embeddings), and Whisper's decode
reads cross-attention K/V that both packages project from the same
encoder output, the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import (forward as jforward, init_model as jinit,
                          init_serve_cache as jcache, param_count as jcount,
                          serve_step as jstep)
from repro.models import layers as jL
from repro.models.transformer import encode as jencode
from repro_torch import configs as tcfg
from repro_torch.convert import lm_params_from_reference, reference_leaf
from repro_torch.models import (LayerSpec, forward, init_model,
                                init_serve_cache, param_count, serve_step)
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from torch_threads import _one_thread  # noqa: F401 (autouse)

DENSE = ["smollm_135m", "qwen3_4b", "yi_6b"]
DTYPES = ["float32", "bfloat16"]
# whole models: the dense decoders (Qwen2.5's with q/k/v biases drawn
# away from 0, see ``_models``), Mamba2 (attention-free), InternVL2
# (patch embeddings prepended), Whisper (encoder-decoder) and Jamba's
# hybrid period (Mamba2, attention, MoE); Jamba's bf16 forward is held
# in test_torch_jamba.py, where its MoE's near-tie flips are explained
LM_CASES = [(a, dt) for a in DENSE + ["qwen25_32b", "mamba2_130m",
                                      "internvl2_2b", "whisper_medium"]
            for dt in DTYPES] + [("jamba_v01_52b", "float32")]
SCALED = {"jamba_v01_52b"}      # held at SCALED_ATOL in fp32
FP32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=0.08, atol=0.08)
# fp32, deep hybrid models (Jamba's period of 8 layers: Mamba2,
# attention, MoE): each layer adds its fp32 roundings (XLA's and
# PyTorch's exp differ by an ulp, the scan and the MoE sum in another
# order), so near 0 an element is held at 1e-4 of the largest |value|
# instead of FP32_TOL's 1e-5: seen 2.6e-5 on decode logits up to 3.8
# against the reference, 7.4e-5 on logits up to 5.1 decode against the
# port's forward, 4.9e-5 on an embedding gradient whose largest is 2.0
SCALED_ATOL = 1e-4


def _cfgs(arch, dtype):
    return (dataclasses.replace(jcfg.get_smoke(arch), dtype=dtype),
            dataclasses.replace(tcfg.get_smoke(arch), dtype=dtype))


# sd of the q/k/v biases drawn into a ``qkv_bias`` config's reference
# tree: the reference initialises them to 0, where a dropped or
# misplaced bias would not show
QKV_BIAS_SD = 0.25


def _drawn_qkv_biases(params):
    """``params`` with every q/k/v projection bias drawn from
    N(0, QKV_BIAS_SD^2) (numpy, seed 34)."""
    rng = np.random.default_rng(34)

    def leaf(path, x):
        keys = [getattr(k, "key", None) for k in path]
        if keys[-1] == "bias" and keys[-2] in ("wq", "wk", "wv"):
            return jnp.asarray(rng.normal(scale=QKV_BIAS_SD, size=x.shape),
                               x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


def _models(arch, dtype):
    """(reference cfg, port cfg, reference params, port model) from the
    reference's ``init_model(PRNGKey(0))``; a ``qkv_bias`` config's
    q/k/v biases are drawn away from 0 first (``_drawn_qkv_biases``)."""
    jc, tc = _cfgs(arch, dtype)
    with jax.threefry_partitionable(False):
        params = jinit(jax.random.PRNGKey(0), jc)
    if jc.qkv_bias:
        params = _drawn_qkv_biases(params)
    tree = jax.tree.map(np.asarray, params)
    return jc, tc, params, lm_params_from_reference(tree, tc, device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, argmax=False, scaled=False):
    """``scaled``: fp32 at ``SCALED_ATOL`` of want's largest |value|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    if scaled and dtype == "float32":
        tol = dict(tol, atol=max(tol["atol"],
                                 SCALED_ATOL * float(np.abs(want).max())))
    np.testing.assert_allclose(got, want, **tol)
    if argmax:
        agree = (got.argmax(-1) == want.argmax(-1)).mean()
        assert agree > (0.999 if dtype == "float32" else 0.95), agree


def _x(shape, dtype, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _stubs(cfg, B, seed=13):
    """The stub modality inputs the config takes, as numpy arrays:
    ``frontend`` (B, Tf, D) patch embeddings, ``enc_frames`` (B, Te, D)
    encoder frames."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.n_frontend_tokens:
        out["frontend"] = rng.normal(
            size=(B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["enc_frames"] = rng.normal(
            size=(B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return out


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["stack"]["l0"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_matches_reference(dtype):
    jx, tx = _x((2, 5, 64), dtype)
    scale = np.random.default_rng(1).normal(size=(64,)).astype(np.float32)
    want = jL.rms_norm({"scale": jnp.asarray(scale)}, jx, 1e-5)
    got = tL.rms_norm(tL.RMSNorm(torch.from_numpy(scale)), tx, 1e-5)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope_matches_reference(dtype):
    jx, tx = _x((2, 12, 4, 16), dtype)
    pos = np.random.default_rng(2).integers(0, 4096, (2, 12)).astype(np.int32)
    want = jL.apply_rope(jx, jnp.asarray(pos), 1e6)
    got = tL.apply_rope(tx, torch.from_numpy(pos), 1e6)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_apply_attention_prefill_and_decode_match_reference(arch, dtype):
    jc, tc, params, model = _models(arch, dtype)
    jp, tp = _layer0(params)["attn"], model.stack[0].attn
    jx, tx = _x((2, 9, jc.d_model), dtype, seed=3)
    want, _ = jL.apply_attention(jp, jc, jx)
    got, _ = tL.apply_attention(tp, tc, tx)
    _close(got, want, dtype)
    # one decode step at position 9 of a cache holding 9 rows
    jcache_ = jL.init_attn_cache(jc, 2, 16)
    tcache = tL.init_attn_cache(tc, 2, 16, device="cpu")
    rng = np.random.default_rng(4)
    kv = rng.normal(size=(2, 2, 9, jc.n_kv_heads, jc.head_dim)) \
        .astype(np.float32)
    jcache_["k"] = jcache_["k"].at[:, :9].set(kv[0].astype(jcache_["k"]
                                                          .dtype))
    jcache_["v"] = jcache_["v"].at[:, :9].set(kv[1].astype(jcache_["v"]
                                                          .dtype))
    jcache_["len"] = jnp.asarray(9, jnp.int32)
    tcache["k"][:, :9] = torch.from_numpy(kv[0])
    tcache["v"][:, :9] = torch.from_numpy(kv[1])
    tcache["len"] = 9
    jx1, tx1 = _x((2, 1, jc.d_model), dtype, seed=5)
    want, jnew = jL.apply_attention(jp, jc, jx1, cache=jcache_)
    got, tnew = tL.apply_attention(tp, tc, tx1, cache=tcache)
    _close(got, want, dtype)
    _close(tnew["k"], jnew["k"], dtype)
    _close(tnew["v"], jnew["v"], dtype)
    assert tnew["len"] == int(jnew["len"]) == 10


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gelu", [False, True], ids=["swiglu", "gelu"])
def test_apply_mlp_matches_reference(gelu, dtype):
    jc, tc = _cfgs("qwen3_4b", dtype)
    jc = dataclasses.replace(jc, mlp_gelu=gelu)
    tc = dataclasses.replace(tc, mlp_gelu=gelu)
    with jax.threefry_partitionable(False):
        jp = jL.init_mlp(jax.random.PRNGKey(7), jc)
    rng = np.random.default_rng(8)
    # nonzero biases, so that they are held too
    jp = jax.tree.map(lambda a: jnp.asarray(
        a if a.ndim > 1 else rng.normal(size=a.shape).astype(np.float32)),
        jp)
    dt = tL.cdtype(tc)

    def dense(d):
        return tL.Dense(torch.tensor(np.asarray(d["w"])).to(dt),
                        torch.tensor(np.asarray(d["bias"])).to(dt)
                        if "bias" in d else None)

    tp = tL.MLP(dense(jp["wi"]), dense(jp["wdown"]),
                dense(jp["wg"]) if "wg" in jp else None)
    jx, tx = _x((2, 6, jc.d_model), dtype, seed=9)
    _close(tL.apply_mlp(tp, tc, tx), jL.apply_mlp(jp, jc, jx), dtype)


@pytest.mark.parametrize("arch,dtype", LM_CASES)
def test_forward_matches_reference(arch, dtype):
    jc, tc, params, model = _models(arch, dtype)
    toks = np.random.default_rng(10).integers(0, jc.vocab_size, (2, 24))
    batch = {"tokens": toks, **_stubs(jc, 2)}
    want, jaux = jforward(params, jc, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                          remat=False)
    got, aux = forward(model, tc, batch)
    assert got.dtype == tL.cdtype(tc)
    if tc.n_experts:
        assert float(aux) > 0.0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    else:
        assert float(aux) == float(jaux) == 0.0
    _close(got, want, dtype, argmax=True, scaled=arch in SCALED)


@pytest.mark.parametrize("arch,dtype", LM_CASES)
def test_serve_step_matches_reference(arch, dtype):
    """Six decode steps of 4 rows from a cache pre-filled to position 3
    (rows of zeros, as the reference's ``prefilled``; a Mamba2 layer's
    state and conv window start at zeros); the argmax agreement is
    counted over all 24 rows, and every layer's cache is held to the
    reference's (stacked layer i is repeat i // len(pattern) of
    ``l{i % len(pattern)}``).  Whisper's cross K/V are projected in
    both packages from the reference's encoder output, and held too."""
    jc, tc, params, model = _models(arch, dtype)
    toks = np.random.default_rng(11).integers(0, jc.vocab_size, (4, 6))
    enc = None
    if jc.is_encoder_decoder:
        enc = jencode(params, jc, jnp.asarray(_stubs(jc, 4)["enc_frames"]))
    jc_ = jcache(params, jc, 4, 12, enc_out=enc, prefilled=3)
    tc_ = init_serve_cache(model, tc, 4, 12, prefilled=3,
                           enc_out=None if enc is None
                           else torch.tensor(_np(enc)).to(tL.cdtype(tc)))
    got, want = [], []
    for t in range(6):
        jlg, jc_ = jstep(params, jc, jc_, jnp.asarray(toks[:, t:t + 1]))
        tlg, tc_ = serve_step(model, tc, tc_, toks[:, t:t + 1])
        got.append(_np(tlg))
        want.append(_np(jlg))
    _close(np.concatenate(got), np.concatenate(want), dtype, argmax=True,
           scaled=arch in SCALED)
    assert tc_["pos"] == int(jc_["pos"]) == 9
    P = len(tc.pattern)
    for i, layer in enumerate(tc_["stack"]):
        want_c = jc_["stack"][f"l{i % P}"]["mixer"]
        assert set(layer["mixer"]) == set(want_c)
        for name, t in layer["mixer"].items():
            _close(t, want_c[name][i // P], dtype, scaled=arch in SCALED)
    assert ("stack_cross" in tc_) == ("stack_cross" in jc_)
    for i, ck in enumerate(tc_.get("stack_cross", [])):
        for name in ("k", "v"):
            _close(ck[name], jc_["stack_cross"][f"l{i % P}"][name][i // P],
                   dtype)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward_in_port(arch):
    """Decoding token by token equals the parallel forward pass, in the
    configs' bf16, at tests/test_models.py's tolerance."""
    _, tc = _cfgs(arch, "bfloat16")
    model = init_model(tc, seed=0, device="cpu")
    toks = np.random.default_rng(12).integers(0, tc.vocab_size, (2, 12))
    par, _ = forward(model, tc, {"tokens": toks})
    caches = init_serve_cache(model, tc, 2, 16)
    dec = []
    for t in range(12):
        lg, caches = serve_step(model, tc, caches, toks[:, t:t + 1])
        dec.append(lg[:, 0])
    _close(torch.stack(dec, 1), par, "bfloat16", argmax=True)


@pytest.mark.parametrize("arch", jcfg.ARCHS)
def test_configs_and_param_count_match_reference(arch):
    for get_t, get_j in ((tcfg.get_config, jcfg.get_config),
                         (tcfg.get_smoke, jcfg.get_smoke)):
        t, j = get_t(arch), get_j(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert param_count(t) == jcount(j)
    assert tcfg.ARCHS == jcfg.ARCHS
    assert [dataclasses.asdict(s) for s in tcfg.SHAPES] == \
        [dataclasses.asdict(s) for s in jcfg.SHAPES]


@pytest.mark.parametrize("arch", jcfg.ARCHS)
def test_every_config_builds(arch):
    """Every family of the reference runs in the port: its published
    config passes ``check_supported``, and its smoke config builds
    through ``init_model`` and through ``lm_params_from_reference``
    with the same parameter names, shapes and dtypes, each the shape of
    the reference leaf it stands for."""
    tT.check_supported(tcfg.get_config(arch))
    cfg = tcfg.get_smoke(arch)
    own = init_model(cfg, device="cpu")
    with jax.threefry_partitionable(False):
        params = jinit(jax.random.PRNGKey(0), jcfg.get_smoke(arch))
    tree = jax.tree.map(np.asarray, params)
    carried = lm_params_from_reference(tree, cfg, device="cpu")
    got = {n: (tuple(p.shape), p.dtype) for n, p in own.named_parameters()}
    assert got == {n: (tuple(p.shape), p.dtype)
                   for n, p in carried.named_parameters()}
    for name, (shape, _) in got.items():
        assert reference_leaf(tree, name, cfg).shape == shape, name
    assert sum(np.prod(s) for s, _ in got.values()) == sum(
        x.size for x in jax.tree.leaves(tree))
    assert (own.encoder is not None) == cfg.is_encoder_decoder


def test_check_supported_refuses_an_unknown_mixer():
    cfg = dataclasses.replace(tcfg.get_smoke("qwen3_4b"),
                              pattern=(LayerSpec(mixer="rwkv"),))
    with pytest.raises(NotImplementedError, match="the rwkv mixer"):
        tT.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="the rwkv mixer"):
        init_model(cfg, device="cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_init_model_shapes_and_distributions(arch):
    """The port's own random weights have the reference's leaves,
    shapes and distributions (normal * 1/sqrt(fan_in), norm scales 1)."""
    cfg = tcfg.get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=1, vocab_size=4096)
    model = init_model(cfg, seed=3, device="cpu")
    ref = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0),
                                       dataclasses.replace(
                                           jcfg.get_config(arch),
                                           n_layers=1, vocab_size=4096)))
    want = {jax.tree_util.keystr(k): v.shape
            for k, v in jax.tree_util.tree_leaves_with_path(ref)}
    got = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "stack":      # stack.0.x -> ['stack']['l0'][x]
            parts = ["stack", "l0"] + parts[2:]
            shape = (1,) + tuple(p.shape)
        else:
            shape = tuple(p.shape)
        got["".join(f"['{s}']" for s in parts)] = shape
        assert p.dtype == (torch.float32 if parts[-1] == "scale"
                           else tL.cdtype(cfg))
        if parts[-1] == "scale":
            assert torch.equal(p, torch.ones_like(p))
        elif parts[-1] == "w":
            fan_in = cfg.d_model if parts[-2] in ("embed", "unembed") \
                else p.shape[0]
            std = float(p.float().std()) * np.sqrt(fan_in)
            assert abs(std - 1.0) < 0.05, (name, std)
    assert got == want
