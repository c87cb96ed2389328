"""Jamba's hybrid period (Mamba2, windowed attention, MoE) trained
against the JAX package's, on the CPU.

The jamba smoke model starts from the reference's ``init_model(
PRNGKey(0), cfg)`` weights, carried over as fp32 masters with
gradients (``test_torch_jamba._models``), with and without the
long-context window (8 here); the batch is ``test_torch_moe._batch``
(2 x 32 tokens: one router group, one chunk of the scan, four windows
of 8).

Tolerances, fp32 only: the loss at ``FP32_TOL``, the aux rtol 1e-6,
and every gradient leaf at rtol 1e-4 with atol at ``SCALED_ATOL`` of
its largest |element| (``test_torch_lm.py`` says why and what was
seen), against ``jax.value_and_grad`` of the reference's ``loss_fn``;
remat on and off the same bits.  In bf16 the two packages' attention
and scan round at other places, and the four MoE layers route tokens
at near-ties to other experts, which take the gradient of other tokens:
a step of the function, not the port's (``test_torch_mla.py`` shows
such flips on the deepseek model); in fp32 the routing is the same
bits.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm as lm
import test_torch_moe as moe
from repro.models import loss_fn as jloss_fn
from repro_torch.convert import reference_leaf
from repro_torch.models import loss_fn
from test_torch_jamba import ATTN, WINDOW, _models
from torch_threads import _one_thread  # noqa: F401 (autouse)


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(window):
    jc, tc, params, _ = _models("float32", window)
    jb = {k: jnp.asarray(v.numpy().astype(np.int32))
          for k, v in moe._batch(tc.vocab_size).items()}
    with jax.threefry_partitionable(False):
        (loss, met), grads = jax.jit(jax.value_and_grad(
            lambda p: jloss_fn(p, jc, jb, remat=True), has_aux=True))(params)
    return float(loss), float(met["aux"]), jax.tree.map(np.asarray, grads)


def _port_loss_and_grads(window, remat):
    _, tc, _, model = _models("float32", window, train_=True)
    loss, met = loss_fn(model, tc, moe._batch(tc.vocab_size), remat=remat)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return model, loss.detach(), {k: x.detach() for k, x in met.items()}, \
        dict(zip(named, grads))


@pytest.mark.parametrize("window", [0, WINDOW], ids=["full", "window8"])
def test_jamba_loss_and_gradients_match_reference(window):
    """fp32 (the module docstring says why not bf16), on
    ``test_torch_moe._batch`` (2 x 32 tokens: one router group, one
    chunk, four windows of 8): the loss, the aux and every gradient
    leaf, Mamba2's and the windowed attention's among them."""
    model, loss, met, grads = _port_loss_and_grads(window, remat=True)
    want_loss, want_aux, want_grads = _reference_loss_and_grads(window)
    np.testing.assert_allclose(float(loss), want_loss, **lm.FP32_TOL)
    np.testing.assert_allclose(float(met["aux"]), want_aux,
                               rtol=moe.AUX_RTOL)
    names = {n for n, _ in model.named_parameters()}
    assert set(grads) == names
    for part in ("stack.0.mixer.A_log", "stack.0.mixer.conv_w",
                 "stack.1.moe.router.w", f"stack.{ATTN}.attn.wq.w",
                 "stack.2.mlp.wg.w"):
        assert part in names, part
    for name, g in grads.items():
        want = reference_leaf(want_grads, name, model.cfg)
        got = g.numpy()
        assert got.shape == want.shape and np.isfinite(got).all(), name
        atol = max(lm.FP32_TOL["atol"], lm.SCALED_ATOL * np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol,
                                   err_msg=name)


def test_jamba_remat_gives_the_same_gradient_bits():
    _, la, _, ga = _port_loss_and_grads(WINDOW, remat=True)
    _, lb, _, gb = _port_loss_and_grads(WINDOW, remat=False)
    assert torch.equal(la, lb)
    assert all(torch.equal(ga[n], gb[n]) for n in ga)
