"""Whisper's training in the port against the JAX package's, on the
CPU, and the encoder-decoder family through the port's ``train`` loop.

The whisper smoke model (2 encoder + 2 decoder layers) starts from the
reference's ``init_model(PRNGKey(0), cfg)`` weights, carried over as
fp32 masters with gradients; batches come from the same seeded
``TokenStream`` with the stub encoder frames (``make_lm_batch(...,
enc_frames=)``).  On the CPU the attention gradient is the flash
backward's plain version (``ref.attention_bwd_ref``), without a causal
mask in the encoder and the cross blocks; the cross blocks' k and v
gradients flow back into the encoder.  The helpers here take the arch,
so ``test_torch_internvl2.py`` holds InternVL2 (patch embeddings
prepended) by the same checks.

Tolerances (``test_torch_train.py``'s, which says why):
* ``loss_fn``: fp32, the loss and every gradient leaf (the encoder's
  leaves, the LayerNorm biases and the cross blocks included) at
  ``FP32_TOL``; bf16, the loss at ``BF16_LOSS_RTOL`` and each leaf at
  a relative Frobenius error of ``BF16_GRAD_REL`` (2^-4);
* the port's ``remat`` on and off: the same gradient bits;
* three ``make_train_step`` steps (fp32 at ``n_micro`` 1 and 2, bf16
  at 2): fp32, losses rtol 1e-5 and parameters at ``FP32_TOL``; bf16,
  losses ``BF16_LOSS_RTOL`` and parameters within 2 lr x steps;
* ``train``: the loss falls by the reference's test's margin, and a run
  restarted after a lost device ends bitwise on the uninterrupted run.
"""
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as train
from repro.data import TokenStream as JStream
from repro.data import make_lm_batch as jmake_lm_batch
from repro.launch.train import make_train_step as jmake_train_step
from repro.models import loss_fn as jloss_fn
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs as tcfg
from repro_torch.convert import lm_params_from_reference, reference_leaf
from repro_torch.data import TokenStream, make_lm_batch
from repro_torch.launch.train import make_train_step, train as ttrain
from repro_torch.models import loss_fn
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import FailureSim
from torch_threads import _one_thread  # noqa: F401 (autouse)

ARCH = "whisper_medium"
DTYPES = train.DTYPES


def stubs(cfg):
    """``make_lm_batch``'s keywords for the config's stub inputs."""
    return dict(frontend_tokens=cfg.n_frontend_tokens, d_model=cfg.d_model,
                enc_frames=cfg.encoder_frames if cfg.is_encoder_decoder
                else 0)


def reference_params(arch):
    """The reference's initial params: the same fp32 tree whatever the
    compute dtype (its init reads only the shapes), drawn once."""
    return train._reference_params(arch, "float32")


def port_model(arch, dtype):
    _, tc = train._cfgs(arch, dtype)
    tree = jax.tree.map(np.asarray, reference_params(arch))
    return lm_params_from_reference(tree, tc, device="cpu", train=True)


def batch(cfg, step=0, rows=2, seq=24):
    b = make_lm_batch(TokenStream(cfg.vocab_size, seed=1), step, rows, seq,
                      **stubs(cfg), device="cpu")
    b["labels"][0, 3] = -1        # one masked label
    return b


@functools.lru_cache(maxsize=None)
def reference_loss_and_grads(arch, dtype):
    """The reference's (loss, grads as numpy) on ``batch``, with its
    remat."""
    jc, tc = train._cfgs(arch, dtype)
    jb = {k: jnp.asarray(v.numpy().astype(np.int32)
                         if v.dtype == torch.int64 else v.numpy())
          for k, v in batch(tc).items()}
    with jax.threefry_partitionable(False):
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jloss_fn(p, jc, jb, remat=True), has_aux=True))(
                reference_params(arch))
    return float(loss), jax.tree.map(np.asarray, grads)


def port_loss_and_grads(arch, dtype, remat):
    model = port_model(arch, dtype)
    loss, met = loss_fn(model, model.cfg, batch(model.cfg), remat=remat)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return model, loss.detach(), {k: x.detach() for k, x in met.items()}, \
        dict(zip(named, grads))


def check_loss_and_gradients(arch, dtype, remat):
    model, loss, met, grads = port_loss_and_grads(arch, dtype, remat)
    want_loss, want_grads = reference_loss_and_grads(arch, dtype)
    assert float(met["tokens"]) == 2 * 24 - 1 and float(met["aux"]) == 0.0
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), want_loss, **train.FP32_TOL)
    else:
        np.testing.assert_allclose(float(loss), want_loss,
                                   rtol=train.BF16_LOSS_RTOL)
    assert set(grads) == {n for n, _ in model.named_parameters()}
    for name, g in grads.items():
        want = reference_leaf(want_grads, name, model.cfg).astype(np.float32)
        got = g.to(torch.float32).numpy()
        assert got.shape == want.shape and np.isfinite(got).all(), name
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **train.FP32_TOL,
                                       err_msg=name)
        else:
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= train.BF16_GRAD_REL, (name, rel)
    return grads


def check_three_steps(arch, n_micro, dtype):
    """Three steps of ``make_train_step`` from the same weights on the
    same batches (4 x 16 tokens with the stub inputs)."""
    jc, tc = train._cfgs(arch, dtype)
    params = reference_params(arch)
    model = port_model(arch, dtype)
    ost = adamw_init(dict(model.named_parameters()))
    with jax.threefry_partitionable(False):
        jopt = jadamw_init(params)
        jstep = jax.jit(jmake_train_step(jc, JAdamWConfig(**train.OPT),
                                         n_micro=n_micro))
    step = make_train_step(tc, AdamWConfig(**train.OPT), n_micro=n_micro)
    js, ts = JStream(jc.vocab_size, seed=2), TokenStream(tc.vocab_size,
                                                         seed=2)
    for i in range(3):
        with jax.threefry_partitionable(False):
            params, jopt, jm = jstep(params, jopt, jmake_lm_batch(
                js, i, 4, 16, **stubs(jc)))
        model, ost, tm = step(model, ost, make_lm_batch(
            ts, i, 4, 16, **stubs(tc), device="cpu"))
        rtol = 1e-5 if dtype == "float32" else train.BF16_LOSS_RTOL
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=rtol)
    assert int(ost.step) == int(jopt.step) == 3
    tree = jax.tree.map(np.asarray, params)
    for name, p in model.named_parameters():
        want = reference_leaf(tree, name, tc)
        got = p.detach().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **train.FP32_TOL,
                                       err_msg=name)
        else:
            assert np.abs(got - want).max() <= 2 * train.OPT["lr"] * 3, name


def check_loss_decreases(arch):
    """The reference's ``test_train_loss_decreases`` on the port."""
    out = ttrain(tcfg.get_smoke(arch), steps=30, batch=4, seq=64,
                 log_every=0, opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=5,
                                                  total_steps=30),
                 device="cpu")
    assert len(out["losses"]) == 30 and out["final_step"] == 30
    first, last = np.mean(out["losses"][:5]), np.mean(out["losses"][-5:])
    assert last < first - 0.2, (first, last)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "noremat"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_gradients_match_reference(dtype, remat):
    grads = check_loss_and_gradients(ARCH, dtype, remat)
    for name in ("encoder.stack.0.attn.wk.w", "encoder.final_norm.bias",
                 "stack.1.cross.wv.w", "stack.0.norm_cross.bias",
                 "stack.0.mlp.wi.bias"):
        assert float(grads[name].abs().max()) > 0, name


@pytest.mark.parametrize("dtype", DTYPES)
def test_remat_gives_the_same_gradient_bits(dtype):
    _, loss_a, _, ga = port_loss_and_grads(ARCH, dtype, True)
    _, loss_b, _, gb = port_loss_and_grads(ARCH, dtype, False)
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(ga[n], gb[n]) for n in ga)


@pytest.mark.parametrize("n_micro,dtype", [(1, "float32"), (2, "float32"),
                                           (2, "bfloat16")])
def test_three_train_steps_match_reference(n_micro, dtype):
    check_three_steps(ARCH, n_micro, dtype)


def test_train_loss_decreases():
    check_loss_decreases(ARCH)


def test_train_restarts_after_a_lost_device_bitwise():
    """Eight steps with a checkpoint every 4 and a device lost at step
    6: the run resumes from step 4's save and ends on the uninterrupted
    run's bits (params, AdamW moments, step)."""
    cfg = tcfg.get_smoke(ARCH)
    kw = dict(steps=8, batch=2, seq=16, log_every=0, device="cpu",
              opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8))
    whole = ttrain(cfg, **kw)
    sim = FailureSim(fail_at=[6])
    with tempfile.TemporaryDirectory() as d:
        out = ttrain(cfg, ckpt_dir=d, save_every=4, failure_sim=sim, **kw)
    assert sim.failures == 1 and out["final_step"] == 8
    assert len(out["losses"]) == 10
    assert out["losses"][:6] == whole["losses"][:6]
    assert out["losses"][6:] == whole["losses"][4:]
    assert train._same_state(out, whole)
