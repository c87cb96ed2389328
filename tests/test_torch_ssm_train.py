"""Mamba2 training against the JAX package's, on the CPU, and the SSM
family through the port's ``train`` loop.

The mamba2 smoke model (two Mamba2 layers, no MLP) starts from the
reference's ``init_model(PRNGKey(0), cfg)`` weights, carried over as
fp32 masters with gradients; batches come from the same seeded
``TokenStream``.  The gradient of the SSD scan is autograd's through
the port's PyTorch ops, where the reference takes ``jax.grad`` of its
``jnp`` scan (the exp of segment sums masked before it: no NaN reaches
a gradient).

Tolerances (``test_torch_train.py``'s):
* ``loss_fn``, fp32: the loss and every gradient leaf at ``FP32_TOL``;
  bf16: the loss at ``BF16_LOSS_RTOL`` and each leaf at a relative
  Frobenius error of ``BF16_GRAD_REL`` (2^-4), but ``A_log``'s.  Its
  gradient sums d(log-decay) dt over every position of the batch, terms
  of both signs, so bf16's roundings of x, B, C and dt move it far more
  than any other leaf: the reference's own bf16 gradient leaves its
  fp32 one by 0.175 (layer 0) and 0.021 (layer 1), the port's by 0.095
  and 0.089, and the two bf16 gradients differ by 0.082.  ``A_log``'s
  leaves are held to the fp32 reference's gradient at ``A_LOG_REL``
  (2^-3);
* the port's ``remat`` on and off: the same gradient bits;
* three ``make_train_step`` steps: fp32, losses rtol 1e-5 and
  parameters at ``FP32_TOL``; bf16, losses ``BF16_LOSS_RTOL`` and
  parameters within 2 lr x steps (``test_torch_train.py`` says why);
* ``train``: the loss falls by the reference's test's margin, and a run
  restarted after a lost device ends bitwise on the uninterrupted run.
"""
import tempfile

import jax
import numpy as np
import pytest
import torch

import test_torch_jamba as jamba
import test_torch_train as train
from repro.data import TokenStream as JStream
from repro.data import make_lm_batch as jmake_lm_batch
from repro.launch.train import make_train_step as jmake_train_step
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs as tcfg
from repro_torch.convert import reference_leaf
from repro_torch.data import TokenStream, make_lm_batch
from repro_torch.launch.train import make_train_step, train as ttrain
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import FailureSim
from torch_threads import _one_thread  # noqa: F401 (autouse)

ARCH = "mamba2_130m"
DTYPES = train.DTYPES
A_LOG_REL = 2.0 ** -3


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "noremat"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_gradients_match_reference(dtype, remat):
    model, loss, met, grads = train._port_loss_and_grads(ARCH, dtype, remat)
    want_loss, want_grads = train._reference_loss_and_grads(ARCH, dtype)
    assert float(met["tokens"]) == 2 * 24 - 1 and float(met["aux"]) == 0.0
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), want_loss, **train.FP32_TOL)
    else:
        np.testing.assert_allclose(float(loss), want_loss,
                                   rtol=train.BF16_LOSS_RTOL)
    names = {n for n, _ in model.named_parameters()}
    assert set(grads) == names and "stack.1.mixer.A_log" in names
    for name, g in grads.items():
        want = reference_leaf(want_grads, name, model.cfg).astype(np.float32)
        got = g.to(torch.float32).numpy()
        assert got.shape == want.shape and np.isfinite(got).all(), name
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **train.FP32_TOL,
                                       err_msg=name)
        elif name.endswith(".A_log"):
            fp32 = reference_leaf(train._reference_loss_and_grads(
                ARCH, "float32")[1], name, model.cfg)
            assert _rel(got, fp32) <= A_LOG_REL, (name, _rel(got, fp32))
        else:
            assert _rel(got, want) <= train.BF16_GRAD_REL, (name,
                                                            _rel(got, want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_remat_gives_the_same_gradient_bits(dtype):
    _, loss_a, _, ga = train._port_loss_and_grads(ARCH, dtype, True)
    _, loss_b, _, gb = train._port_loss_and_grads(ARCH, dtype, False)
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(ga[n], gb[n]) for n in ga)


@pytest.mark.parametrize("n_micro,dtype", [(1, "float32"), (2, "float32"),
                                           (1, "bfloat16")])
def test_three_train_steps_match_reference(n_micro, dtype):
    """Three steps of ``make_train_step`` from the same weights on the
    same batches of 4 x 32 tokens (one chunk of the scan; with
    n_micro=2, two microbatches of 2 rows)."""
    jc, tc = train._cfgs(ARCH, dtype)
    params = train._reference_params(ARCH, dtype)
    model = train._port_model(ARCH, dtype)
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
            params, jopt, jm = jstep(params, jopt,
                                     jmake_lm_batch(js, i, 4, 32))
        model, ost, tm = step(model, ost,
                              make_lm_batch(ts, i, 4, 32, device="cpu"))
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


@pytest.mark.parametrize("arch", [ARCH, "jamba_v01_52b"])
def test_train_loss_decreases(arch):
    """The reference's ``test_train_loss_decreases`` on the SSM family:
    the mamba2 smoke model, and Jamba's period with the long-context
    window (8 here, so that the 64-token sequences are cut by it; 4 x
    64 tokens a step are four router groups)."""
    cfg = tcfg.get_smoke(arch)
    if arch != ARCH:
        cfg = jamba._windowed(cfg, jamba.WINDOW)
    out = ttrain(cfg, steps=30, batch=4, seq=64, log_every=0,
                 opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=5,
                                     total_steps=30), device="cpu")
    assert len(out["losses"]) == 30 and out["final_step"] == 30
    first, last = np.mean(out["losses"][:5]), np.mean(out["losses"][-5:])
    assert last < first - 0.2, (first, last)


def test_train_restarts_after_a_lost_device_bitwise():
    """Ten steps with a checkpoint every 5 and a device lost at step 7:
    the run resumes from step 5's save and ends on the uninterrupted
    run's bits (params, AdamW moments, step)."""
    cfg = tcfg.get_smoke(ARCH)
    kw = dict(steps=10, batch=2, seq=32, log_every=0, device="cpu",
              opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10))
    whole = ttrain(cfg, **kw)
    sim = FailureSim(fail_at=[7])
    with tempfile.TemporaryDirectory() as d:
        out = ttrain(cfg, ckpt_dir=d, save_every=5, failure_sim=sim, **kw)
    assert sim.failures == 1 and out["final_step"] == 10
    assert len(out["losses"]) == 12
    assert out["losses"][:7] == whole["losses"][:7]
    assert out["losses"][7:] == whole["losses"][5:]
    assert train._same_state(out, whole)
