"""The port's LM training against the JAX package's, on the CPU.

Both packages start from the same weights: the reference's
``init_model(PRNGKey(0), cfg)`` params, carried into the port as fp32
masters with gradients by ``convert.lm_params_from_reference(...,
train=True)``; batches come from the same seeded ``TokenStream``.  On
the CPU the port's attention and its gradient run the flash kernels'
plain versions (``ref.attention_ref``, ``ref.attention_bwd_ref``).

Tolerances:
* ``loss_fn``, fp32: loss and every gradient leaf rtol 1e-4, atol 1e-5
  (``test_torch_lm.py``'s): the same float program up to summation
  order;
* ``loss_fn``, bf16 (the configs' own dtype): both packages round every
  projection, norm, activation and the logits to bf16 (2^-9 relative
  each), at places that differ (PyTorch's silu and index backward keep
  fp32 inside where XLA rounds, XLA keeps fusions in fp32 where PyTorch
  rounds each op).  The loss averages the rounded logits: rtol 1e-3.
  A gradient leaf collects such roundings along the backward of two
  layers and the head, some twenty deep, which would add up to
  20 x 2^-9 = 0.04 at worst if all went one way: each leaf is held to a
  relative error of 2^-4 in the Frobenius norm (elementwise tests mean
  nothing near 0 in bf16);
* the port's ``remat`` on and off: the same gradient bits (the
  checkpointed layer recomputes the same float program);
* ``adamw_update`` and ``cosine_schedule``: the reference's fp32
  program, elementwise: rtol 1e-6 (they agree bitwise on this CPU);
* three ``make_train_step`` steps: fp32, losses rtol 1e-5 and
  parameters rtol 1e-4, atol 1e-5; bf16, losses rtol 1e-3 and
  parameters atol 2 lr x steps: Adam's normalised update moves a leaf
  by about lr a step, and a leaf whose bf16 gradient is near 0 can move
  either way in the two packages; the deepseek smoke model (MLA, MoE)
  in fp32, where an element whose first gradient cancels to fp32's
  rounding level is held as in bf16 (the test says why);
* ``make_lm_batch`` and ``lm_batches``: bitwise;
* ``train``: its loss falls by the reference's test's margin; a run
  resumed from a checkpoint, and a run restarted after ``FailureSim``,
  end bitwise on the uninterrupted run.
"""
import dataclasses
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.data import TokenStream as JStream
from repro.data import lm_batches as jlm_batches
from repro.data import make_lm_batch as jmake_lm_batch
from repro.launch.train import make_train_step as jmake_train_step
from repro.models import init_model as jinit
from repro.models import loss_fn as jloss_fn
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine
from repro.optim.adamw import OptState as JOptState
from repro_torch import configs as tcfg
from repro_torch.convert import (lm_params_from_reference,
                                 opt_state_from_reference, reference_leaf)
from repro_torch.data import TokenStream, lm_batches, make_lm_batch
from repro_torch.launch.serve import generate
from repro_torch.launch.train import make_train_step, train
from repro_torch.models import for_serving, loss_fn
from repro_torch.optim import (AdamWConfig, OptState, adamw_init,
                               adamw_update, cosine_schedule)
from repro_torch.runtime import FailureSim
from torch_threads import _one_thread  # noqa: F401 (autouse)

DENSE = ["smollm_135m", "qwen3_4b", "yi_6b"]
DTYPES = ["float32", "bfloat16"]
FP32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_REL = 2.0 ** -4
OPT = dict(lr=1e-3, warmup_steps=5, total_steps=30)


def _cfgs(arch, dtype):
    return (dataclasses.replace(jcfg.get_smoke(arch), dtype=dtype),
            dataclasses.replace(tcfg.get_smoke(arch), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _reference_params(arch, dtype):
    jc, _ = _cfgs(arch, dtype)
    with jax.threefry_partitionable(False):
        return jinit(jax.random.PRNGKey(0), jc)


def _port_model(arch, dtype):
    _, tc = _cfgs(arch, dtype)
    tree = jax.tree.map(np.asarray, _reference_params(arch, dtype))
    return lm_params_from_reference(tree, tc, device="cpu", train=True)


def _batch(vocab, step=0, batch=2, seq=24):
    b = make_lm_batch(TokenStream(vocab, seed=1), step, batch, seq,
                      device="cpu")
    b["labels"][0, 3] = -1        # one masked label
    return b


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(arch, dtype):
    """The reference's (loss, grads as numpy) on ``_batch``, with its
    remat (the same values as without)."""
    jc, tc = _cfgs(arch, dtype)
    jb = {k: jnp.asarray(v.numpy().astype(np.int32))
          for k, v in _batch(tc.vocab_size).items()}
    with jax.threefry_partitionable(False):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jloss_fn(p, jc, jb, remat=True), has_aux=True))(
                _reference_params(arch, dtype))
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_loss_and_grads(arch, dtype, remat):
    model = _port_model(arch, dtype)
    loss, met = loss_fn(model, model.cfg, _batch(model.cfg.vocab_size),
                        remat=remat)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return model, loss.detach(), {k: x.detach() for k, x in met.items()}, \
        dict(zip(named, grads))


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "noremat"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_gradients_match_reference(arch, dtype, remat):
    model, loss, met, grads = _port_loss_and_grads(arch, dtype, remat)
    want_loss, want_grads = _reference_loss_and_grads(arch, dtype)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert float(met["tokens"]) == 2 * 24 - 1 and float(met["aux"]) == 0.0
    assert torch.equal(met["nll"], loss)
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), want_loss, **FP32_TOL)
    else:
        np.testing.assert_allclose(float(loss), want_loss,
                                   rtol=BF16_LOSS_RTOL)
    assert set(grads) == {n for n, _ in model.named_parameters()}
    for name, g in grads.items():
        want = reference_leaf(want_grads, name, model.cfg).astype(np.float32)
        got = g.to(torch.float32).numpy()
        assert got.shape == want.shape and np.isfinite(got).all(), name
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **FP32_TOL, err_msg=name)
        else:
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= BF16_GRAD_REL, (name, rel)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_remat_gives_the_same_gradient_bits(arch, dtype):
    _, loss_a, _, ga = _port_loss_and_grads(arch, dtype, True)
    _, loss_b, _, gb = _port_loss_and_grads(arch, dtype, False)
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(ga[n], gb[n]) for n in ga)


def test_training_model_holds_fp32_masters_with_gradients():
    model = _port_model("smollm_135m", "bfloat16")
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.requires_grad, name
    serving = lm_params_from_reference(
        jax.tree.map(np.asarray, _reference_params("smollm_135m",
                                                   "bfloat16")),
        model.cfg, device="cpu")
    for (name, p), (_, s) in zip(model.named_parameters(),
                                 serving.named_parameters()):
        assert not s.requires_grad
        # the serving model holds the masters cast to the compute dtype
        want = p.detach() if name.endswith("scale") else \
            p.detach().to(torch.bfloat16)
        assert s.dtype == want.dtype and torch.equal(s, want), name


def _tree(shapes, seed, scale=1.0, positive=False):
    rng = np.random.default_rng(seed)
    return {k: (scale * (rng.random(size=s) if positive
                         else rng.normal(size=s))).astype(np.float32)
            for k, s in shapes.items()}


def test_adamw_update_matches_reference():
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    P, G = _tree(shapes, 0), _tree(shapes, 1)
    M, V = _tree(shapes, 2, 0.1), _tree(shapes, 3, 0.01, positive=True)
    with jax.threefry_partitionable(False):
        jp, js, jm = jadamw_update(
            JAdamWConfig(**OPT), {k: jnp.asarray(x) for k, x in P.items()},
            {k: jnp.asarray(x) for k, x in G.items()},
            JOptState({k: jnp.asarray(x) for k, x in M.items()},
                      {k: jnp.asarray(x) for k, x in V.items()},
                      jnp.asarray(6, jnp.int32)))
    params = {k: torch.from_numpy(x.copy()) for k, x in P.items()}
    tp, ts, tm = adamw_update(
        AdamWConfig(**OPT), params,
        {k: torch.from_numpy(x) for k, x in G.items()},
        OptState({k: torch.from_numpy(x.copy()) for k, x in M.items()},
                 {k: torch.from_numpy(x.copy()) for k, x in V.items()},
                 torch.tensor(6, dtype=torch.int32)))
    assert tp is params and int(ts.step) == int(js.step) == 7
    for k in shapes:
        for got, want in ((tp[k], jp[k]), (ts.m[k], js.m[k]),
                          (ts.v[k], js.v[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=0)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 5, 6, 17, 30, 31, 1000])
def test_cosine_schedule_matches_reference(step):
    """At 0, through warm-up, at its end, on the cosine and past the
    last step (where it rests at min_lr_ratio)."""
    got = cosine_schedule(AdamWConfig(**OPT),
                          torch.tensor(step, dtype=torch.int32))
    with jax.threefry_partitionable(False):
        want = jcosine(JAdamWConfig(**OPT), jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_adamw_init_and_opt_state_carry_over():
    params = _reference_params("qwen3_4b", "float32")
    model = _port_model("qwen3_4b", "float32")
    ost = adamw_init(dict(model.named_parameters()))
    assert int(ost.step) == 0 and ost.step.dtype == torch.int32
    assert all(float(x.abs().sum()) == 0 for x in ost.m.values())
    rng = np.random.default_rng(4)
    with jax.threefry_partitionable(False):
        jst = JOptState(jax.tree.map(lambda p: jnp.asarray(
            rng.normal(size=p.shape), jnp.float32), params),
            jax.tree.map(lambda p: jnp.asarray(
                rng.random(size=p.shape), jnp.float32), params),
            jnp.asarray(3, jnp.int32))
    got = opt_state_from_reference(jax.tree.map(np.asarray, jst), model)
    assert int(got.step) == 3 and set(got.m) == set(ost.m)
    for name in got.m:
        assert np.array_equal(got.m[name].numpy(), reference_leaf(
            jax.tree.map(np.asarray, jst.m), name, model.cfg))
        assert np.array_equal(got.v[name].numpy(), reference_leaf(
            jax.tree.map(np.asarray, jst.v), name, model.cfg))


# (arch, n_micro, dtype): SmolLM-135M's smoke config keeps its ids; the
# deepseek smoke model (MLA, MoE with router groups of 64: a step's
# 4 x 16 tokens are one group, each microbatch's of n_micro=2 32 tokens
# a group) in fp32 only: in bf16 the two packages' attention rounds at
# other places and its router sends one to four tokens a step to other
# experts at near-ties (``test_torch_mla.py`` holds such flips to their
# explanation), which moves the loss by up to 2e-3, a step of the
# function itself, not the train step's
THREE_STEPS = [("smollm_135m", n, dt) for n in (1, 2) for dt in DTYPES] \
    + [("deepseek_v2_lite_16b", n, "float32") for n in (1, 2)]
# fp32's a-priori error bound of a gradient element that sums 2^8 terms
# (a microbatch's tokens times a layer's fan), relative to its leaf's
# largest element: n u = 2^8 2^-24
CANCELLED = 2.0 ** -16


def _first_gradients(jc, params, batch, n_micro):
    """The reference's gradient as its first AdamW update receives it:
    the mean over the microbatches of ``jax.grad`` of ``loss_fn``."""
    B = batch["tokens"].shape[0]
    with jax.threefry_partitionable(False):
        grads = [jax.grad(lambda p, mb=mb: jloss_fn(p, jc, mb,
                                                    remat=True)[0])(params)
                 for mb in (jax.tree.map(lambda x, i=i: x[i * B // n_micro:
                                                          (i + 1) * B
                                                          // n_micro], batch)
                            for i in range(n_micro))]
    return jax.tree.map(lambda *g: np.asarray(sum(g) / n_micro), *grads)


@pytest.mark.parametrize(
    "arch,n_micro,dtype", THREE_STEPS,
    ids=[f"{n}-{dt}" if arch == "smollm_135m" else f"deepseek-{n}-{dt}"
         for arch, n, dt in THREE_STEPS])
def test_three_train_steps_match_reference(arch, n_micro, dtype):
    """Three steps of ``make_train_step`` from the same weights on the
    same batches.  The deepseek model's first AdamW update moves an
    element by lr g / (|g| + eps): where its fp32 gradient cancels to
    below ``CANCELLED`` of its leaf's largest, g is rounding noise in
    both packages and the update's size and sign with it, so such an
    element is held as the bf16 case holds every one, to 2 lr x steps
    (one element of 270,880 at n_micro=2: 9.2e-8 in a leaf whose largest
    is 5.8e-2); every other element at ``FP32_TOL``."""
    jc, tc = _cfgs(arch, dtype)
    params = _reference_params(arch, dtype)
    model = _port_model(arch, dtype)
    ost = adamw_init(dict(model.named_parameters()))
    with jax.threefry_partitionable(False):
        jopt = jadamw_init(params)
        jstep = jax.jit(jmake_train_step(jc, JAdamWConfig(**OPT),
                                         n_micro=n_micro))
    step = make_train_step(tc, AdamWConfig(**OPT), n_micro=n_micro)
    js, ts = JStream(jc.vocab_size, seed=2), TokenStream(tc.vocab_size,
                                                         seed=2)
    first = None
    for i in range(3):
        jb = jmake_lm_batch(js, i, 4, 16)
        if i == 0 and arch != "smollm_135m":
            first = _first_gradients(jc, params, jb, n_micro)
        with jax.threefry_partitionable(False):
            params, jopt, jm = jstep(params, jopt, jb)
        model, ost, tm = step(model, ost,
                              make_lm_batch(ts, i, 4, 16, device="cpu"))
        rtol = 1e-5 if dtype == "float32" else BF16_LOSS_RTOL
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=rtol)
    assert int(ost.step) == int(jopt.step) == 3
    tree = jax.tree.map(np.asarray, params)
    for name, p in model.named_parameters():
        want = reference_leaf(tree, name, tc)
        got = p.detach().numpy()
        if dtype == "float32" and first is None:
            np.testing.assert_allclose(got, want, **FP32_TOL, err_msg=name)
        elif dtype == "float32":
            g0 = np.abs(reference_leaf(first, name, tc))
            cancelled = g0 <= CANCELLED * g0.max()
            close = np.isclose(got, want, **FP32_TOL)
            assert (close | cancelled).all(), name
            assert np.abs(got - want)[cancelled].max(initial=0.0) \
                <= 2 * OPT["lr"] * 3, name
        else:
            assert np.abs(got - want).max() <= 2 * OPT["lr"] * 3, name


@pytest.mark.parametrize("extra", [{}, dict(frontend_tokens=3, d_model=8,
                                            enc_frames=5)],
                         ids=["tokens", "stubs"])
def test_lm_batches_are_the_reference_bits(extra):
    ts, js = TokenStream(512, seed=7), JStream(512, seed=7)
    got = make_lm_batch(ts, 11, 3, 17, **extra, device="cpu")
    with jax.threefry_partitionable(False):
        want = jmake_lm_batch(js, 11, 3, 17, **extra)
        wants = [b for _, b in zip(range(3), jlm_batches(js, 4, 2, 9))]
    assert set(got) == set(want)
    for k in want:
        assert got[k].device.type == "cpu"
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
        assert got[k].numpy().dtype.kind == np.asarray(want[k]).dtype.kind
    for a, b in zip(lm_batches(ts, 4, 2, 9, device="cpu"), wants):
        assert all(np.array_equal(a[k].numpy(), np.asarray(b[k]))
                   for k in b)


@pytest.mark.parametrize("arch", ["smollm_135m", "deepseek_v2_lite_16b"])
def test_train_loss_decreases(arch):
    """The reference's ``test_train_loss_decreases``, on the port: a
    dense model and the deepseek smoke model (MLA and MoE; 4 x 64 tokens
    a step, four router groups)."""
    cfg = tcfg.get_smoke(arch)
    out = train(cfg, steps=30, batch=4, seq=64, log_every=0,
                opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=5,
                                    total_steps=30), device="cpu")
    assert len(out["losses"]) == 30 and out["final_step"] == 30
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    assert last < first - 0.2, (first, last)


def _same_state(a, b):
    pa, pb = dict(a["params"].named_parameters()), \
        dict(b["params"].named_parameters())
    return all(torch.equal(pa[n], pb[n]) for n in pa) and all(
        torch.equal(a["opt_state"].m[n], b["opt_state"].m[n])
        and torch.equal(a["opt_state"].v[n], b["opt_state"].v[n])
        for n in pa) and int(a["opt_state"].step) == int(
            b["opt_state"].step)


def _run(steps, **kw):
    return train(tcfg.get_smoke("qwen3_4b"), steps=steps, batch=2, seq=16,
                 log_every=0, opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=2,
                                                  total_steps=8),
                 device="cpu", **kw)


def test_train_resumes_from_a_checkpoint_bitwise():
    whole = _run(8)
    with tempfile.TemporaryDirectory() as d:
        first = _run(5, ckpt_dir=d, save_every=2)
        assert first["final_step"] == 5
        rest = _run(8, ckpt_dir=d, save_every=2)
    assert len(rest["losses"]) == 3 and rest["final_step"] == 8
    assert rest["losses"] == whole["losses"][5:]
    assert _same_state(rest, whole)


def test_train_restarts_after_a_lost_device_bitwise():
    whole = _run(8)
    sim = FailureSim(fail_at=[5])
    with tempfile.TemporaryDirectory() as d:
        out = _run(8, ckpt_dir=d, save_every=2, failure_sim=sim)
    assert sim.failures == 1 and out["final_step"] == 8
    # step 4 runs twice: the restart resumes from step 4's save
    assert len(out["losses"]) == 9
    assert out["losses"][:5] == whole["losses"][:5]
    assert out["losses"][5:] == whole["losses"][4:]
    assert _same_state(out, whole)
    # without a checkpoint the restart begins again from step 0
    sim = FailureSim(fail_at=[3])
    out = _run(8, failure_sim=sim)
    assert len(out["losses"]) == 11 and _same_state(out, whole)


def test_generate_on_a_trained_model_is_its_cast_once_copy():
    """Serving a training model (fp32 masters, cast on every read) gives
    the tokens of ``for_serving``'s copy, whose weights are cast to the
    compute dtype once: the same bits."""
    cfg = tcfg.get_smoke("qwen3_4b")
    model = _run(3)["params"]
    serving = for_serving(model)
    assert not any(p.requires_grad for p in serving.parameters())
    for (name, p), s in zip(model.named_parameters(), serving.parameters()):
        want = torch.float32 if name.endswith(".scale") else torch.bfloat16
        assert s.dtype == want, name
    prompts = TokenStream(cfg.vocab_size, seed=3).batch(0, 2, 8)[:, :8]
    assert np.array_equal(generate(cfg, model, prompts, max_new=6),
                          generate(cfg, serving, prompts, max_new=6))
