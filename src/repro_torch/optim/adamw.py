"""AdamW and its schedule, in plain PyTorch.

The counterpart of ``repro/optim/adamw.py``, with its arithmetic: fp32
moments over fp32 master parameters, global-norm clipping, decoupled
weight decay on every leaf (norm scales included), a cosine schedule
with linear warm-up.  Parameters, gradients and moments are dicts of
tensors by parameter name (``dict(model.named_parameters())``); the
step counter is a 0-d int32 tensor, as the reference's.

The reference computes ``b ** step``, the warm-up ratio and the cosine
as fp32 device arrays; so does this module, with every constant an
fp32 tensor on the parameters' device (Python floats would round the
schedule in float64).  The update writes the parameters and moments in
place (the reference returns new arrays): the same values, without a
second copy of the model and its moments.  The reference has no kernel
here; the elementwise passes run through ``torch._foreach_*``.

``adamw_init_sharded`` and ``adamw_update_sharded`` are the ZeRO-1 form
of the data-parallel step (``launch/train.py``'s
``make_sharded_train_step``): a rank holds its slice of each moment
leaf that the plan shards, updates that slice of the parameters with
the same float program, and all-gathers the updated slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Sequence, Tuple

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    m: Tree
    v: Tree
    step: torch.Tensor      # 0-d int32


def adamw_init(params: Tree) -> OptState:
    """Zero fp32 moments shaped like ``params``, step 0."""
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    dev = next(iter(params.values())).device
    return OptState(m=zeros,
                    v={k: torch.zeros_like(z) for k, z in zeros.items()},
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor), in fp32:
    ``lr * min(step / warmup, 1) * (min_lr_ratio + (1 - min_lr_ratio) *
    0.5 (1 + cos(pi t)))``, t the clipped share of the steps after
    warm-up."""
    dev = step.device
    s = step.to(torch.float32)
    warm = torch.minimum(s / _f32(max(cfg.warmup_steps, 1), dev),
                         _f32(1.0, dev))
    t = torch.clamp((s - _f32(cfg.warmup_steps, dev))
                    / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev),
                    0.0, 1.0)
    cos = _f32(0.5, dev) * (_f32(1.0, dev) + torch.cos(_f32(math.pi, dev)
                                                        * t))
    frac = _f32(cfg.min_lr_ratio, dev) + _f32(1 - cfg.min_lr_ratio, dev) \
        * cos
    return _f32(cfg.lr, dev) * warm * frac


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves, in order, of each leaf's fp32 sum of
    squares."""
    total = None
    for x in tree.values():
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _update_leaves(cfg: AdamWConfig, p, g, m, v, step: torch.Tensor,
                   gnorm: torch.Tensor) -> Tuple[torch.Tensor,
                                                 torch.Tensor]:
    """AdamW on lists of leaves (or slices of them), in place: clip
    ``g`` by ``gnorm``, update ``m``, ``v`` and ``p`` -> (step + 1, lr).
    Every operation is elementwise, so a slice of a leaf gets the bits
    of the same elements of the whole leaf's update."""
    dev = p[0].device
    scale = torch.minimum(_f32(1.0, dev),
                          _f32(cfg.grad_clip, dev) / (gnorm + _f32(1e-9, dev)))
    g = torch._foreach_mul([x.to(torch.float32) for x in g], scale)

    step = step + 1
    lr = cosine_schedule(cfg, step)
    sf = step.to(torch.float32)
    b1c = _f32(1.0, dev) - torch.pow(_f32(cfg.b1, dev), sf)
    b2c = _f32(1.0, dev) - torch.pow(_f32(cfg.b2, dev), sf)

    # m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
    new_m = torch._foreach_add(torch._foreach_mul(m, _f32(cfg.b1, dev)),
                               torch._foreach_mul(g, _f32(1 - cfg.b1, dev)))
    new_v = torch._foreach_add(
        torch._foreach_mul(v, _f32(cfg.b2, dev)),
        torch._foreach_mul(torch._foreach_mul(g, _f32(1 - cfg.b2, dev)), g))
    # du = (m / b1c) / (sqrt(v / b2c) + eps) + wd p;  p = p - lr du
    den = torch._foreach_add(torch._foreach_sqrt(
        torch._foreach_div(new_v, b2c)), _f32(cfg.eps, dev))
    du = torch._foreach_add(
        torch._foreach_div(torch._foreach_div(new_m, b1c), den),
        torch._foreach_mul([x.to(torch.float32) for x in p],
                           _f32(cfg.weight_decay, dev)))
    new_p = torch._foreach_sub([x.to(torch.float32) for x in p],
                               torch._foreach_mul(du, lr))
    for dst, src in zip(p, new_p):
        dst.copy_(src)
    for dst, src in zip(m, new_m):
        dst.copy_(src)
    for dst, src in zip(v, new_v):
        dst.copy_(src)
    return step, lr


def _checked_keys(params: Tree, grads: Tree) -> list:
    keys = list(params)
    missing = [k for k in keys if grads.get(k) is None]
    if missing:
        raise ValueError(f"adamw_update: no gradient for {missing[:3]}")
    return keys


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree,
                 state: OptState) -> Tuple[Tree, OptState, dict]:
    """One AdamW step: clip ``grads`` to ``cfg.grad_clip`` by their
    global norm, update the moments and the parameters (in place) ->
    (params, new state, {"grad_norm", "lr"}).  ``grads`` has
    ``params``' keys; a missing gradient raises."""
    keys = _checked_keys(params, grads)
    gnorm = global_norm({k: grads[k] for k in keys})
    step, lr = _update_leaves(cfg, [params[k] for k in keys],
                              [grads[k] for k in keys],
                              [state.m[k] for k in keys],
                              [state.v[k] for k in keys], state.step, gnorm)
    return params, OptState(state.m, state.v, step), \
        {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# ZeRO-1: moments sharded over a world of ranks
# ---------------------------------------------------------------------------

def adamw_init_sharded(params: Tree, plan) -> OptState:
    """``adamw_init`` of one rank under ``plan`` (a
    ``launch.specs.TrainStatePlan``): zero fp32 moments of a rank's
    slice of each leaf (the whole leaf where the plan replicates it),
    step 0."""
    zeros = {k: torch.zeros(plan.shard_shape(k), dtype=torch.float32,
                            device=p.device) for k, p in params.items()}
    dev = next(iter(params.values())).device
    return OptState(m=zeros,
                    v={k: torch.zeros_like(z) for k, z in zeros.items()},
                    step=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def adamw_update_sharded(cfg: AdamWConfig, params: Tree, grads: Tree,
                         state: OptState, plan, rank: int,
                         all_gather: Callable[[torch.Tensor], torch.Tensor]
                         ) -> Tuple[Tree, OptState, dict]:
    """``adamw_update`` with ZeRO-1 moments: ``state`` holds rank
    ``rank``'s moment slices under ``plan``, ``grads`` the full gradients
    (equal on every rank, as after an all-reduce) and ``params`` the
    replicated fp32 masters.  The global norm is taken from the full
    gradients in ``global_norm``'s leaf order, so it is the same bits on
    every rank; each sharded leaf's slice is updated with its moment
    slice and every replicated leaf whole; then ``all_gather`` (this
    rank's flat fp32 slices -> every rank's, in rank order) fills the
    other ranks' slices of ``params``.  A leaf's slice is bitwise the
    same elements of ``adamw_update``'s result on the whole state."""
    keys = _checked_keys(params, grads)
    gnorm = global_norm({k: grads[k] for k in keys})
    step, lr = _update_leaves(cfg, [plan.shard(k, params[k], rank)
                                    for k in keys],
                              [plan.shard(k, grads[k], rank) for k in keys],
                              [state.m[k] for k in keys],
                              [state.v[k] for k in keys], state.step, gnorm)
    sharded = [(k, params[k]) for k in keys
               if plan.moment_dims[k] is not None]
    if sharded:
        gather_slices(plan, sharded, rank, all_gather)
    return params, OptState(state.m, state.v, step), \
        {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def gather_slices(plan, leaves: Sequence[Tuple[str, torch.Tensor]],
                  rank: int,
                  all_gather: Callable[[torch.Tensor], torch.Tensor]
                  ) -> None:
    """Fill every rank's slice of each full leaf of ``leaves`` ((name,
    tensor shaped like that parameter) pairs, sharded under ``plan``)
    from the ranks that hold them: this rank's slices go out in one flat
    fp32 buffer through ``all_gather``, and every slice of the result is
    copied into its place."""
    local = torch.cat([plan.shard(k, x, rank).reshape(-1)
                       for k, x in leaves])
    n = plan.world_size
    every = all_gather(local).view(n, local.numel())
    off = 0
    for k, x in leaves:
        shard, d = plan.shard_shape(k), plan.moment_dims[k]
        size = math.prod(shard)
        part = every[:, off:off + size].reshape((n,) + shard)
        x.copy_(part.movedim(0, d).reshape(plan.shapes[k]))
        off += size
