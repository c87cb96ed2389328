"""Training step and loop: grad-accumulated, restartable.

The counterpart of ``repro/launch/train.py``.  ``make_train_step``
builds ``step(params, opt_state, batch) -> (params, opt_state,
metrics)`` with microbatch gradient accumulation: the microbatch
gradients are summed in fp32 and divided by their number, as the
reference's scan does.  ``train`` is the runnable driver (the port's
``examples/train_lm.py`` path): data pipeline, checkpoint/auto-resume,
straggler monitor, failure-restart.

``params`` is the port's ``Transformer`` built with ``train=True``
(fp32 masters with gradients); AdamW updates its leaves in place.  A
checkpoint is ``(params as a dict by parameter name, OptState)`` in the
layout of ``checkpoint/ckpt.py``.  The reference's
``make_sharded_train_step`` (a jit over a TPU mesh) waits for the
data-parallel slice over ``torch.distributed`` (ROADMAP A10.1b).  Every
config trains here: ``train``'s batches carry the stub ``frontend``
patch embeddings and the encoder's ``enc_frames`` where the config has
them, and the microbatch split slices every leaf of a batch along its
first axis.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .._device import DeviceLike, resolve_device, synchronize
from ..checkpoint import CheckpointManager
from ..data import TokenStream, make_lm_batch
from ..models import init_model, loss_fn
from ..models.config import ModelConfig
from ..models.transformer import Transformer
from ..obs import clock
from ..optim import AdamWConfig, OptState, adamw_init, adamw_update
from ..runtime import FailureSim, StragglerMonitor


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    n_micro: int = 1, remat: bool = True):
    """Returns ``step(params, opt_state, batch) -> (params, opt, metrics)``
    with metrics ``{"loss", "grad_norm", "lr"}`` (0-d tensors).

    ``n_micro`` splits the batch into that many microbatches along its
    first axis (which it must divide); their gradients are summed in
    fp32, then divided by ``n_micro``, and so is the loss.
    """

    def grads_of(params: Transformer, names, leaves, mb):
        loss, _ = loss_fn(params, cfg, mb, remat=remat)
        return loss.detach(), dict(zip(names, torch.autograd.grad(
            loss, leaves)))

    def step(params: Transformer, opt_state: OptState,
             batch: Dict[str, Any]):
        named = dict(params.named_parameters())
        names, leaves = list(named), list(named.values())
        if n_micro == 1:
            loss, grads = grads_of(params, names, leaves, batch)
        else:
            B = batch["tokens"].shape[0]
            if B % n_micro:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"n_micro={n_micro}")
            micro = [{k: x[i * (B // n_micro):(i + 1) * (B // n_micro)]
                      for k, x in batch.items()} for i in range(n_micro)]
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in named.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=params.device)
            for mb in micro:
                l, g = grads_of(params, names, leaves, mb)
                grads = {k: grads[k] + g[k].to(torch.float32)
                         for k in names}
                loss = loss + l
                del g
            grads = {k: g / n_micro for k, g in grads.items()}
            loss = loss / n_micro
        named, opt_state, om = adamw_update(opt_cfg, named, grads,
                                            opt_state)
        return params, opt_state, {"loss": loss, **om}

    return step


def _state(params: Transformer, opt_state: OptState):
    """The checkpointed tree: (params by name, OptState)."""
    return ({n: p.detach() for n, p in params.named_parameters()},
            opt_state)


@torch.no_grad()
def _load(params: Transformer, tree) -> OptState:
    """Copy a restored (params by name, OptState) into ``params``."""
    named, opt_state = tree
    for n, p in params.named_parameters():
        p.copy_(named[n])
    return opt_state


def train(cfg: ModelConfig, *, steps: int = 100, batch: int = 8,
          seq: int = 128, opt_cfg: Optional[AdamWConfig] = None,
          ckpt_dir: Optional[str] = None, save_every: int = 50,
          seed: int = 0, n_micro: int = 1, log_every: int = 10,
          failure_sim: Optional[FailureSim] = None,
          device: DeviceLike = None) -> Dict[str, Any]:
    """Single-host training loop on ``device`` (the card unless given):
    the model from ``seed`` (``init_model(..., train=True)``), the
    synthetic ``TokenStream`` of ``seed``, checkpoints every
    ``save_every`` steps and at the end into ``ckpt_dir`` (resumed from
    its newest on start), a restart from the newest checkpoint (or from
    scratch) when ``failure_sim`` raises ``DeviceLost``.  Returns
    ``{"losses", "params", "opt_state", "runtime_s", "final_step"}``;
    ``losses`` holds one float a step run, restarted steps included.
    A step's time, read after its loss reaches the host, feeds the
    straggler monitor."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps)
    step_fn = make_train_step(cfg, opt_cfg, n_micro=n_micro)
    stream = TokenStream(cfg.vocab_size, seed=seed)
    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    mon = StragglerMonitor()

    params = init_model(cfg, seed, device=dev, train=True)
    opt_state = adamw_init(dict(params.named_parameters()))
    start = 0
    if mgr is not None:
        restored = mgr.restore_latest(_state(params, opt_state))
        if restored is not None:
            start, tree = restored
            opt_state = _load(params, tree)

    losses = []
    t0 = clock.perf_counter()
    i = start
    while i < steps:
        try:
            if failure_sim is not None:
                failure_sim.check(i)
            b = make_lm_batch(
                stream, i, batch, seq,
                frontend_tokens=cfg.n_frontend_tokens,
                d_model=cfg.d_model,
                enc_frames=cfg.encoder_frames
                if cfg.is_encoder_decoder else 0, device=dev)
            ts = clock.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, b)
            losses.append(float(m["loss"]))
            mon.record(clock.perf_counter() - ts)
            if log_every and i % log_every == 0:
                print(f"step {i:5d}  loss {losses[-1]:.4f}  "
                      f"gnorm {float(m['grad_norm']):.3f}  "
                      f"lr {float(m['lr']):.2e}")
            i += 1
            if mgr is not None and (i % save_every == 0 or i == steps):
                mgr.save(i, _state(params, opt_state))
        except FailureSim.DeviceLost:
            if failure_sim is None:
                raise
            restored = mgr.restore_latest(_state(params, opt_state)) \
                if mgr else None
            if restored is None:
                i = 0
                params = init_model(cfg, seed, device=dev, train=True)
                opt_state = adamw_init(dict(params.named_parameters()))
            else:
                i, tree = restored
                opt_state = _load(params, tree)
    if mgr is not None:
        mgr.wait()
    synchronize(dev)
    return {"losses": losses, "params": params, "opt_state": opt_state,
            "runtime_s": clock.perf_counter() - t0, "final_step": i}
