"""Training step and loop: grad-accumulated, data-parallel, restartable.

The counterpart of ``repro/launch/train.py``.  ``make_train_step``
builds ``step(params, opt_state, batch) -> (params, opt_state,
metrics)`` with microbatch gradient accumulation: the microbatch
gradients are summed in fp32 and divided by their number, as the
reference's scan does.  ``make_sharded_train_step`` is the reference's
jit over a mesh under its ``dponly`` variant, over ``torch.distributed``:
every rank of the mesh takes its share of the global batch
(``specs.batch_shard``), the ranks' fp32 gradients are summed in one
flat all-reduce, and AdamW updates ZeRO-1 moment slices
(``specs.train_state_plan``) before an all-gather of the updated
parameters.  ``train`` is the runnable loop (the port's
``examples/train_lm.py`` path): data pipeline, checkpoint/auto-resume,
straggler monitor, failure-restart, in one process or, with
``variant``, in every rank of the current process group.

``params`` is the port's ``Transformer`` built with ``train=True``
(fp32 masters with gradients); AdamW updates its leaves in place.  A
checkpoint is ``(params as a dict by parameter name, OptState)`` in the
layout of ``checkpoint/ckpt.py``, with unsharded moments whichever step
wrote it.  Every config trains here: ``train``'s batches carry the stub
``frontend`` patch embeddings and the encoder's ``enc_frames`` where the
config has them, and the microbatch split slices every leaf of a batch
along its first axis.
"""
from __future__ import annotations

import math
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device, synchronize
from ..checkpoint import CheckpointManager
from ..configs.shapes import ShapeSpec
from ..core.distributed import _WIRE_NAMES, _groups_along
from ..data import TokenStream, make_lm_batch
from ..models import init_model, loss_fn
from ..models.config import ModelConfig
from ..models.transformer import Transformer
from ..obs import clock
from ..optim import (AdamWConfig, OptState, adamw_init, adamw_init_sharded,
                     adamw_update, adamw_update_sharded, gather_slices)
from ..runtime import FailureSim, StragglerMonitor
from .specs import (TrainStatePlan, batch_shard, effective_variant,
                    train_state_plan)


def _microbatches(batch: Dict[str, Any], n_micro: int
                  ) -> List[Dict[str, Any]]:
    """``batch`` cut into ``n_micro`` microbatches along the first axis
    of every leaf (which ``n_micro`` must divide), in order."""
    B = batch["tokens"].shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} is not a multiple of "
                         f"n_micro={n_micro}")
    if n_micro == 1:
        return [batch]
    b = B // n_micro
    return [{k: x[i * b:(i + 1) * b] for k, x in batch.items()}
            for i in range(n_micro)]


def _accumulate(params: Transformer, cfg: ModelConfig,
                micro: List[Dict[str, Any]], remat: bool,
                weights: Optional[torch.Tensor] = None,
                grads: Optional[Dict[str, torch.Tensor]] = None,
                loss: Optional[torch.Tensor] = None):
    """(loss, gradients by name) over the microbatches ``micro``: each
    microbatch's loss and fp32 gradient, times ``weights[i]`` where
    given, summed into zeros and divided by their number, as the
    reference's scan does; one microbatch is written, not summed, so its
    bits (a -0.0 included) are autograd's.  The result goes into
    ``grads`` (fp32 tensors by name) and ``loss`` (a 0-d fp32 tensor)
    where they are given; else one unweighted microbatch returns
    autograd's gradients themselves and the rest fresh fp32 tensors."""
    named = dict(params.named_parameters())
    names, leaves = list(named), list(named.values())
    k = len(micro)
    own = k == 1 and weights is None and grads is None
    if grads is None and not own:
        grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for n, p in named.items()}
        loss = torch.zeros((), dtype=torch.float32, device=params.device)
    for i, mb in enumerate(micro):
        l, _ = loss_fn(params, cfg, mb, remat=remat)
        g = torch.autograd.grad(l, leaves)
        l = l.detach()
        if own:
            return l, dict(zip(names, g))
        with torch.no_grad():
            if weights is not None:
                l = l * weights[i]
            (loss.copy_ if k == 1 else loss.add_)(l)
            for n, x in zip(names, g):
                x = x.to(torch.float32)
                if weights is not None:
                    x = x * weights[i]
                (grads[n].copy_ if k == 1 else grads[n].add_)(x)
        del g
    if k > 1:
        with torch.no_grad():
            for x in grads.values():
                x.div_(k)
            loss.div_(k)
    return loss, grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    n_micro: int = 1, remat: bool = True):
    """Returns ``step(params, opt_state, batch) -> (params, opt, metrics)``
    with metrics ``{"loss", "grad_norm", "lr"}`` (0-d tensors).

    ``n_micro`` splits the batch into that many microbatches along its
    first axis (which it must divide); their gradients are summed in
    fp32, then divided by ``n_micro``, and so is the loss.
    """

    def step(params: Transformer, opt_state: OptState,
             batch: Dict[str, Any]):
        loss, grads = _accumulate(params, cfg,
                                  _microbatches(batch, n_micro), remat)
        named, opt_state, om = adamw_update(
            opt_cfg, dict(params.named_parameters()), grads, opt_state)
        return params, opt_state, {"loss": loss, **om}

    return step


# ---------------------------------------------------------------------------
# data parallel: the reference's make_sharded_train_step(variant="dponly")
# ---------------------------------------------------------------------------

_MESH_AXES = ("pod", "data", "model")    # the reference's dponly axes
_FLAGS = ("dponly", "flashvjp", "noremat")
_ALIGN = 128       # elements: each leaf's gradient starts 512 bytes in
_SAVE_CHUNK = 1 << 24    # elements a checkpoint's moment gather holds


def _flat_offsets(shapes: Dict[str, Tuple[int, ...]]
                  ) -> Tuple[Dict[str, int], int]:
    """Each leaf's offset in one flat gradient buffer, aligned to
    ``_ALIGN`` elements (as the allocator aligns a leaf of its own, so a
    reduction over a leaf's view runs as over the leaf), and the end."""
    offsets, off = {}, 0
    for name, shape in shapes.items():
        offsets[name] = off
        off += -(-math.prod(shape) // _ALIGN) * _ALIGN
    return offsets, off


def _refuse(cfg: ModelConfig, variant: str, eff: str,
            flags: List[str]) -> None:
    """The variants and configs with no data-parallel path here, each
    with the reason (ROADMAP A11 holds what they need)."""
    unknown = [f for f in flags if f not in _FLAGS + ("baseline", "ep")
               and not (f.startswith("micro") and f[5:].isdigit())]
    if unknown:
        raise ValueError(f"variant {variant!r}: flags {unknown} have no "
                         "counterpart in the port; its flags: "
                         f"{', '.join(_FLAGS)}, micro<k>")
    if "ep" in flags:
        raise ValueError(
            f"variant {variant!r}: expert parallelism (MoE's 'ep' path "
            "and models/sharding.py's rules) is ROADMAP A11")
    if "dponly" not in flags:
        why = (f"effective_variant reduces {variant!r} to {eff!r} "
               "(the global batch does not divide the world)"
               if "dponly" in variant.split(",") else
               f"variant {variant!r} is not 'dponly'")
        raise ValueError(
            f"{why}: the baseline's ZeRO-3/TP shardings "
            "(models/sharding.py) are ROADMAP A11; only 'dponly' runs "
            f"data-parallel here (flags: {', '.join(_FLAGS)}, micro<k>)")
    if cfg.n_experts:
        raise ValueError(
            f"{cfg.name}: a config with MoE layers has no data-parallel "
            "step here (ROADMAP A11): the reference never chooses "
            "'dponly' for one, and its load-balance loss E sum(frac_tokens "
            "* frac_probs) is a product of means over the global batch, "
            "which averaging the ranks' gradients does not reproduce")


class ShardedTrainStep:
    """One ``dponly`` training step of this rank of a data group:
    ``step(params, opt_state, local_batch) -> (params, opt_state,
    metrics)``, the parts ``gradients`` and ``apply``, the moments'
    sharded init, gather and shard for checkpoints, and the census of
    the collectives since ``reset_census`` (each call of the step
    resets it first).  Built by :func:`make_sharded_train_step`."""

    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig,
                 plan: TrainStatePlan, group, rank: int, n_micro: int,
                 remat: bool):
        self.cfg, self.opt_cfg, self.plan = cfg, opt_cfg, plan
        self.group, self.rank = group, rank
        self.world_size = plan.world_size
        self.n_micro, self.remat = n_micro, remat
        self._offsets, self._flat_elems = _flat_offsets(plan.shapes)
        self.reset_census()

    # -- the collectives, counted --------------------------------------

    def reset_census(self) -> None:
        self._census = {"all_reduces": 0, "all_gathers": 0,
                        "reduce_elems": 0, "gather_elems": 0,
                        "wire_bytes": 0, "dtypes": set()}

    def census(self) -> Dict[str, Any]:
        """Collectives since the last reset: calls of each kind, the
        elements this rank sent in each kind, their bytes, and dtypes."""
        c = dict(self._census)
        c["dtypes"] = sorted(_WIRE_NAMES.get(d, str(d))
                             for d in c["dtypes"])
        return c

    def _count(self, calls: str, elems: str, t: torch.Tensor) -> None:
        c = self._census
        c[calls] += 1
        c[elems] += t.numel()
        c["wire_bytes"] += t.numel() * t.element_size()
        c["dtypes"].add(t.dtype)

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, group=self.group)
        self._count("all_reduces", "reduce_elems", t)
        return t

    def _all_gather(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(self.world_size * t.numel(), dtype=t.dtype,
                          device=t.device)
        with warnings.catch_warnings():
            # newer torch renames it; the older one on the card has only this
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, t.contiguous(), group=self.group)
        self._count("all_gathers", "gather_elems", t)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    # -- the step --------------------------------------------------------

    def _check(self, named: Dict[str, torch.Tensor]) -> None:
        got = {k: tuple(p.shape) for k, p in named.items()}
        if got != self.plan.shapes:
            raise ValueError("the model's parameters are not the plan's "
                             f"({len(got)} leaves against "
                             f"{len(self.plan.shapes)})")

    def gradients(self, params: Transformer, batch: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(the global batch's loss, the full fp32 gradients by name),
        equal on every rank, from this rank's rows ``batch``.  Each
        microbatch's gradient is weighted by this rank's share of that
        global microbatch's labels (its count over the all-reduced
        count), so the sum over ranks is the gradient of the reference's
        loss on the global microbatch whatever the mask; the weighted
        gradients go through ``make_train_step``'s own accumulation
        (``_accumulate``) into one flat buffer that also carries the
        weighted loss, and the buffer is all-reduced once.  At one rank
        every weight is 1.0 and the result is ``make_train_step``'s
        bits."""
        named = dict(params.named_parameters())
        self._check(named)
        dev = params.device
        micro = _microbatches(batch, self.n_micro)
        counts = torch.stack([
            (torch.as_tensor(mb["labels"], device=dev) >= 0).sum()
            for mb in micro]).to(torch.float32)
        total = self._all_reduce(counts.clone())
        weights = counts / torch.clamp(total, min=1.0)
        flat = torch.zeros(self._flat_elems + 1, dtype=torch.float32,
                           device=dev)
        views = {n: flat[o:o + named[n].numel()].view(named[n].shape)
                 for n, o in self._offsets.items()}
        loss, _ = _accumulate(params, self.cfg, micro, self.remat, weights,
                              views, flat[-1])
        self._all_reduce(flat)
        return loss.clone(), views

    def apply(self, params: Transformer, opt_state: OptState,
              grads: Dict[str, torch.Tensor]
              ) -> Tuple[Transformer, OptState, Dict[str, torch.Tensor]]:
        """AdamW on this rank's moment slices, then the all-gather of the
        updated parameters (``optim.adamw_update_sharded``)."""
        named = dict(params.named_parameters())
        _, opt_state, om = adamw_update_sharded(
            self.opt_cfg, named, grads, opt_state, self.plan, self.rank,
            self._all_gather)
        return params, opt_state, om

    def __call__(self, params: Transformer, opt_state: OptState,
                 batch: Dict[str, Any]):
        self.reset_census()
        loss, grads = self.gradients(params, batch)
        params, opt_state, om = self.apply(params, opt_state, grads)
        return params, opt_state, {"loss": loss, **om}

    # -- the moments -----------------------------------------------------

    def init_opt_state(self, params: Transformer) -> OptState:
        """Zero moments of this rank's slices, step 0."""
        return adamw_init_sharded(dict(params.named_parameters()),
                                  self.plan)

    @torch.no_grad()
    def host_opt_state(self, opt_state: OptState) -> Optional[OptState]:
        """The unsharded moments on rank 0's host, None on the other
        ranks (collective).  The sharded moments are all-gathered a
        chunk of at most ``_SAVE_CHUNK`` elements at a time (a larger
        moment alone), and each chunk is dropped from the devices once
        rank 0 holds its host copy: a save adds about twice a chunk to a
        rank's device memory, never the unsharded moments."""
        plan, host = self.plan, self.rank == 0
        full = ({}, {})
        todo, size = [], 0

        def flush():
            if not todo:
                return
            gathered = []
            for t, k in todo:
                x = torch.empty(plan.shapes[k], dtype=torch.float32,
                                device=opt_state.m[k].device)
                plan.shard(k, x, self.rank).copy_((opt_state.m,
                                                   opt_state.v)[t][k])
                gathered.append((k, x))
            gather_slices(plan, gathered, self.rank, self._all_gather)
            if host:
                for (t, k), (_, x) in zip(todo, gathered):
                    full[t][k] = x.cpu()
            todo.clear()

        for t, tree in enumerate((opt_state.m, opt_state.v)):
            for k, x in tree.items():
                if plan.moment_dims[k] is None:
                    if host:
                        full[t][k] = x.cpu()
                    continue
                n = math.prod(plan.shapes[k])
                if size + n > _SAVE_CHUNK:
                    flush()
                    size = 0
                todo.append((t, k))
                size += n
        flush()
        if not host:
            return None
        return OptState(*({k: f[k] for k in tree}
                          for f, tree in zip(full, (opt_state.m,
                                                    opt_state.v))),
                        opt_state.step.cpu())

    def shard_opt_state(self, full: OptState, device) -> OptState:
        """This rank's slices of unsharded moments, on ``device``."""
        def mine(tree):
            return {k: self.plan.shard(k, x, self.rank).to(
                device, memory_format=torch.contiguous_format, copy=True)
                for k, x in tree.items()}
        return OptState(mine(full.m), mine(full.v), full.step.to(device))

    def full_template(self, opt_state: OptState) -> OptState:
        """An unsharded OptState's shapes and dtypes, on ``meta``: a
        checkpoint restore's template that allocates nothing."""
        def meta(tree):
            return {k: torch.empty(self.plan.shapes[k], dtype=x.dtype,
                                   device="meta") for k, x in tree.items()}
        return OptState(meta(opt_state.m), meta(opt_state.v),
                        opt_state.step)


def make_sharded_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh,
                            shape: ShapeSpec, *, variant: str = "dponly"
                            ) -> Tuple[ShardedTrainStep, TrainStatePlan]:
    """The reference's ``make_sharded_train_step`` under ``dponly``, on
    the ranks of ``mesh`` (a ``torch.distributed`` ``DeviceMesh``; its
    "pod", "data" and "model" dims, then any other, flattened into one
    data group, as ``dponly`` batches over every mesh axis) -> (step,
    plan).  Collective: every rank of the world calls it.

    ``variant`` is parsed as the reference parses it, after
    :func:`specs.effective_variant`: ``dponly`` runs one microbatch
    unless a ``micro<k>`` flag names k (the reference's ``n_micro``
    argument, which ``dponly`` overrides, has no counterpart here);
    ``noremat`` turns off the layers'
    checkpointing (where the reference compares the whole string with
    ``"noremat"``, so that there ``dponly,noremat`` keeps it on);
    ``flashvjp`` changes nothing, the port's attention gradient being
    its flash backward always.  ``baseline``, ``ep``, a variant that
    ``effective_variant`` reduces to ``baseline`` and a config with MoE
    layers raise ValueError naming ROADMAP A11; so does a flag the port
    does not know.

    ``step`` takes this rank's rows of the global batch
    (``specs.batch_shard(batch, step.rank, step.world_size,
    step.n_micro)``), with parameters replicated on every rank and
    moments from ``step.init_opt_state``; its metrics are the global
    batch's ``loss``, the ``grad_norm`` and the ``lr``, equal on every
    rank.  A step runs two all-reduces (the label counts, the flat fp32
    gradients with the loss) and one all-gather (the updated parameter
    slices): ``step.census()``."""
    world = mesh.size()
    eff = effective_variant(variant, shape, world)
    flags = eff.split(",")
    _refuse(cfg, variant, eff, flags)
    n_micro = 1                  # 1-seq-per-device batches need no accum
    for f in flags:              # explicit microbatch override: "micro<k>"
        if f.startswith("micro") and f[5:].isdigit():
            n_micro = int(f[5:])
    plan = train_state_plan(
        dict(init_model(cfg, device="meta", train=True).named_parameters()),
        world, eff)
    names = tuple(mesh.mesh_dim_names or ())
    order = [names.index(a) for a in _MESH_AXES if a in names]
    order += [i for i in range(mesh.ndim) if i not in order]
    group, rank, _ = _groups_along(mesh, order)
    return ShardedTrainStep(cfg, opt_cfg, plan, group, rank, n_micro,
                            remat="noremat" not in flags), plan


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


def _save(mgr: CheckpointManager, i: int, params: Transformer,
          opt_state: OptState, dp: Optional[ShardedTrainStep]) -> None:
    """Checkpoint step ``i``; in a world the moment slices are gathered
    to rank 0's host first (collective) and rank 0 writes the unsharded
    state."""
    if dp is None:
        mgr.save(i, _state(params, opt_state))
        return
    full = dp.host_opt_state(opt_state)
    if full is not None:
        mgr.save(i, _state(params, full))


def _restore(mgr: CheckpointManager, params: Transformer,
             opt_state: OptState, dp: Optional[ShardedTrainStep]):
    """(step, opt_state) of the newest checkpoint, copied into
    ``params``, or None.  In a world every rank waits for rank 0's
    writes, reads the unsharded state to the host and keeps its moment
    slices."""
    if dp is None:
        restored = mgr.restore_latest(_state(params, opt_state))
        if restored is None:
            return None
        i, tree = restored
        return i, _load(params, tree)
    mgr.wait()
    dp.barrier()
    restored = mgr.restore_latest(
        _state(params, dp.full_template(opt_state)), device="cpu")
    if restored is None:
        return None
    i, tree = restored
    return i, dp.shard_opt_state(_load(params, tree), params.device)


def train(cfg: ModelConfig, *, steps: int = 100, batch: int = 8,
          seq: int = 128, opt_cfg: Optional[AdamWConfig] = None,
          ckpt_dir: Optional[str] = None, save_every: int = 50,
          seed: int = 0, n_micro: int = 1, log_every: int = 10,
          failure_sim: Optional[FailureSim] = None,
          device: DeviceLike = None,
          variant: Optional[str] = None) -> Dict[str, Any]:
    """Training loop on ``device`` (the card unless given): the model
    from ``seed`` (``init_model(..., train=True)``), the synthetic
    ``TokenStream`` of ``seed``, checkpoints every ``save_every`` steps
    and at the end into ``ckpt_dir`` (resumed from its newest on start),
    a restart from the newest checkpoint (or from scratch) when
    ``failure_sim`` raises ``DeviceLost``.  Returns ``{"losses",
    "params", "opt_state", "runtime_s", "final_step"}``; ``losses``
    holds one float a step run, restarted steps included.  A step's
    time, read after its loss reaches the host, feeds the straggler
    monitor.

    ``variant`` (e.g. ``"dponly"``) runs the loop in every rank of the
    current process group through :func:`make_sharded_train_step` over
    the whole world: each rank builds step i's global batch from the
    shared stream and takes its rows, so the data are the
    single-process run's; rank 0 writes the checkpoints, in the
    single-process layout; every rank restores from them, so a
    checkpoint of a world of N resumes in a world of M or in one
    process.  Its microbatches come from the variant's ``micro<k>``
    flag: ``n_micro`` other than 1 with a variant raises ValueError.
    The result's ``opt_state`` holds this rank's moment
    slices, and ``step`` the sharded step."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps)
    dp = None
    if variant is None:
        step_fn = make_train_step(cfg, opt_cfg, n_micro=n_micro)
    else:
        if n_micro != 1:
            raise ValueError(
                f"n_micro={n_micro} with variant {variant!r}: a "
                "data-parallel step takes its microbatches from the "
                f"variant's micro<k> flag ('{variant},micro{n_micro}')")
        from torch.distributed.device_mesh import DeviceMesh
        mesh = DeviceMesh(dev.type, torch.arange(dist.get_world_size()),
                          mesh_dim_names=("data",))
        dp, _ = make_sharded_train_step(
            cfg, opt_cfg, mesh, ShapeSpec("train", seq, batch, "train"),
            variant=variant)
        step_fn = dp
    stream = TokenStream(cfg.vocab_size, seed=seed)
    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None
    mon = StragglerMonitor()

    def fresh():
        p = init_model(cfg, seed, device=dev, train=True)
        return p, (adamw_init(dict(p.named_parameters())) if dp is None
                   else dp.init_opt_state(p))

    params, opt_state = fresh()
    start = 0
    if mgr is not None:
        restored = _restore(mgr, params, opt_state, dp)
        if restored is not None:
            start, opt_state = restored

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
            if dp is not None:
                b = batch_shard(b, dp.rank, dp.world_size, dp.n_micro)
            ts = clock.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, b)
            losses.append(float(m["loss"]))
            mon.record(clock.perf_counter() - ts)
            if log_every and i % log_every == 0 and (dp is None
                                                     or dp.rank == 0):
                print(f"step {i:5d}  loss {losses[-1]:.4f}  "
                      f"gnorm {float(m['grad_norm']):.3f}  "
                      f"lr {float(m['lr']):.2e}")
            i += 1
            if mgr is not None and (i % save_every == 0 or i == steps):
                _save(mgr, i, params, opt_state, dp)
        except FailureSim.DeviceLost:
            if failure_sim is None:
                raise
            restored = _restore(mgr, params, opt_state, dp) \
                if mgr else None
            if restored is None:
                i = 0
                params, opt_state = fresh()
            else:
                i, opt_state = restored
    if mgr is not None:
        mgr.wait()
    synchronize(dev)
    return {"losses": losses, "params": params, "opt_state": opt_state,
            "runtime_s": clock.perf_counter() - t0, "final_step": i,
            "step": dp}
