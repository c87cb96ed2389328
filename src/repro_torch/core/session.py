"""Session API: compose a model, run one Gibbs chain or several.

The counterpart of ``repro/core/session.py``: ``ModelBuilder``,
``Session``, ``SessionResult``/``BlockResult``, ``SweepInfo``,
``resolve_chains`` and the wrappers ``TrainSession``, ``GFASession`` and
``smurff()``, for any entity/block graph -- Normal, FixedNormal, Macau
(side information) and spike-and-slab priors, sparse and dense blocks,
Fixed/Adaptive Gaussian and probit noise:

    b = ModelBuilder(num_latent=128)            # device="cuda" implied
    b.add_entity("compound", n_compounds, side_info=ecfp)   # -> Macau
    b.add_entity("protein", n_proteins)
    b.add_block("compound", "protein", train, test=(i, j, v),
                noise=AdaptiveGaussian())
    result = b.session(burnin=4, nsamples=2, seed=0, chains=2).run()

    smurff(train, test=(i, j, v), num_latent=16)          # one call
    GFASession([X1, X2], num_latent=8).run()["W"]         # dense views

``chains=C`` runs C chains, one after the other
(``gibbs.multi_chain_step``): chain c is bitwise the single-chain run
keyed ``gibbs.chain_keys(seed, C)[c]``, so chain 0 is the ``chains=1``
run.  ``None`` defers to ``REPRO_CHAINS``.  ``save_freq=k`` with
``save_dir`` streams every k-th post-burnin sample to disk in the
reference's store layout (``model.json`` plus ``samples/step_<sweep>/``,
and for C > 1 one such store a chain under ``chain_<c>/``), and the
run's split-R-hat and bulk-ESS go to ``diagnostics.json``;
``PredictSession`` serves such a store and ``run(resume=True)``
continues it from its last complete sample.

``recorder=`` (or ``REPRO_OBS=1``) records a ``session/compile`` span
around the kernels' build and one ``sweep`` span a sweep, fenced with
``synchronize`` only while the recorder is enabled, and exports them to
``REPRO_OBS_DIR`` or ``save_dir/obs``.  The chain is the same bits with
the recorder on or off.

``mesh=`` (a ``torch.distributed`` ``DeviceMesh``) runs the chain
through the distributed sweep of ``distributed.py``, one process a
rank, ``pipeline=`` choosing the fixed factor's exchange and
``chain_axis=`` a mesh dim to split the chains over; every rank calls
``run()``, gets the whole result, and rank 0 alone writes the store.  A
model outside the sharded subset warns, naming why, and every rank runs
the whole single-device sweep.  Errors the two packages share carry the
reference's messages.  Macau's
side^T side is computed once, when the builder makes the data
(``gibbs.with_side_grams``), where the reference recomputes it each
sweep.

Where the reference runs a discarded warm-up sweep to split jit
compilation from sweep time, the port has nothing to compile but its
CUDA kernels: ``compile_s`` is the time to build them (zero when they
are built already, and on the CPU).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import warnings
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from .._device import DeviceLike, resolve_device, synchronize
from ..obs import clock, resolve_recorder
from .blocks import BlockDef, DenseBlock, EntityDef, ModelDef, dense_block
from .diagnostics import (Diagnostics, compute_diagnostics,
                          save_diagnostics, split_rhat)
from .gibbs import (MFData, MFState, gibbs_step, init_chain_states,
                    init_state, multi_chain_step, stack_states,
                    unstack_state, with_side_grams)
from .noise import AdaptiveGaussian, FixedGaussian, ProbitNoise
from .predict import PredictAccumulator, TestSet, make_test_set
from .priors import (FixedNormalPrior, MacauPrior, NormalPrior,
                     SpikeAndSlabPrior)
from .sparse import SparseMatrix

def _check_mesh(mesh: Any, pipeline: Optional[str],
                chain_axis: Optional[str]) -> None:
    """Validate the distributed sweep's knobs where they are given:
    ``mesh`` a ``DeviceMesh``, a known ``pipeline``, and no
    ``chain_axis`` without a mesh."""
    from .distributed import resolve_pipeline
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(mesh, DeviceMesh):
            raise ValueError(
                "mesh= takes a torch.distributed.device_mesh.DeviceMesh "
                "(dims named from ('pod', 'data', 'model') plus an "
                f"optional chain axis), got {type(mesh).__name__}")
    if pipeline is not None:
        resolve_pipeline(pipeline)
    if chain_axis is not None and mesh is None:
        raise ValueError(
            f"chain_axis={chain_axis!r} shards chains over a mesh "
            "axis; pass mesh= too")


def _place_step(model: ModelDef, data: MFData, state: MFState, mesh: Any,
                pipeline: Optional[str], chains: int,
                chain_axis: Optional[str]):
    """(distributed step or None, data, state) to run the chain with.

    Without a mesh: None and the inputs (the single-device sweep), with
    a warning when a ``pipeline`` was asked for.  With one: this rank's
    placement from ``make_distributed_step`` (one chain) or
    ``make_multi_chain_step``, after a warning naming why when the model
    is outside the sharded subset (then every rank runs the whole
    single-device sweep).
    """
    from .distributed import (distributed_unsupported_reason,
                              make_distributed_step, make_multi_chain_step,
                              resolve_pipeline)
    resolve_pipeline(pipeline)
    if mesh is None:
        if pipeline is not None:
            warnings.warn(
                f"pipeline={pipeline!r} has no effect without mesh=: "
                "the session runs the single-device sweep",
                stacklevel=3)
        return None, data, state
    reason = distributed_unsupported_reason(model, mesh, data)
    if reason is not None:
        warnings.warn(
            f"model is outside the sharded subset on this mesh "
            f"({reason}); every rank runs the whole single-device sweep",
            stacklevel=3)
    if chains == 1:
        return make_distributed_step(model, mesh, data, state,
                                     pipeline=pipeline)
    return make_multi_chain_step(model, mesh, data, state,
                                 pipeline=pipeline, chains=chains,
                                 chain_axis=chain_axis)


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BlockResult:
    """Per-block view of a run: traces + posterior-mean test metrics."""

    block: int
    entities: Tuple[str, str]
    rmse_train_trace: List[float]
    rmse_test_trace: List[float]
    rmse_test: Optional[float]
    auc_test: Optional[float]
    predictions: Optional[np.ndarray]
    pred_var: Optional[np.ndarray]


@dataclasses.dataclass
class SessionResult:
    """Result of one run (one chain, or ``chains=C`` stacked chains).

    The test fields mirror the first block carrying a test set and
    ``rmse_train_trace`` is block 0's; ``blocks`` holds every block's
    traces and metrics.  With ``chains=C > 1``:

    * test metrics and ``predictions`` pool the posterior draws of all
      chains, step-major and chain-minor (the order ``PredictSession``
      replays from a multi-chain store);
    * ``blocks``' train traces follow chain 0; ``chain_blocks[c]``
      carries every chain's per-block traces;
    * ``state`` and ``factor_means`` entries gain a leading ``(C,)``
      chain axis;
    * ``diagnostics`` holds split-R-hat / bulk-ESS per monitored
      quantity over the (C, draws) traces.

    ``resumed_from`` is the completed-sweep count a ``run(resume=True)``
    continued from (None for a fresh run); traces and accumulators then
    cover only the sweeps after it.
    """

    rmse_test: Optional[float]
    auc_test: Optional[float]
    predictions: Optional[np.ndarray]
    pred_var: Optional[np.ndarray]
    rmse_train_trace: List[float]
    rmse_test_trace: List[float]
    nsamples: int
    runtime_s: float
    state: MFState
    samples: Optional[List[Tuple[np.ndarray, ...]]] = None
    blocks: List[BlockResult] = dataclasses.field(default_factory=list)
    factor_means: Optional[List[np.ndarray]] = None
    save_dir: Optional[str] = None
    n_chains: int = 1
    chain_blocks: Optional[List[List[BlockResult]]] = None
    diagnostics: Optional[Diagnostics] = None
    resumed_from: Optional[int] = None
    compile_s: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        """JSON-able scalar summary of the run, with the reference's
        keys; ``total_s`` is ``compile_s + runtime_s``."""
        return {
            "rmse_test": self.rmse_test,
            "auc_test": self.auc_test,
            "nsamples": self.nsamples,
            "n_chains": self.n_chains,
            "runtime_s": self.runtime_s,
            "compile_s": self.compile_s,
            "total_s": self.compile_s + self.runtime_s,
            "rmse_train_trace": [float(v) for v in
                                 self.rmse_train_trace],
            "rmse_test_trace": [float(v) for v in self.rmse_test_trace],
            "save_dir": self.save_dir,
            "resumed_from": self.resumed_from,
            "diagnostics": (self.diagnostics.to_dict()
                            if self.diagnostics is not None else None),
        }

    def mean_from_samples(self, test: TestSet, row_entity: int = 0,
                          col_entity: int = 1) -> np.ndarray:
        """Posterior-mean predictions recomputed from the kept samples
        (``run(keep_samples=True)``): the in-session accumulator over
        the samples in the run's order, on the device of the run's
        state, so for the run's test set it is bitwise ``predictions``.
        """
        if self.samples is None:
            raise ValueError("no samples kept; run(keep_samples=True)")
        dev = self.state.factors[row_entity].device
        if not isinstance(test, TestSet):
            test = make_test_set(*test, device=dev)
        acc = PredictAccumulator(test)
        for fs in self.samples:
            acc.update(torch.from_numpy(fs[row_entity]).to(dev),
                       torch.from_numpy(fs[col_entity]).to(dev))
        return acc.mean.cpu().numpy()


class SweepInfo(NamedTuple):
    """What a per-sweep callback sees (after the sweep completed).

    ``metrics`` are always chain 0's scalars; a multi-chain run also
    passes the stacked ``(C,)`` metrics as ``chain_metrics`` (None when
    ``chains == 1``).  ``state`` is the full post-sweep state, stacked
    over chains for a multi-chain run.
    """

    sweep: int          # 0-based global sweep index
    phase: str          # "burnin" | "sample"
    state: MFState      # post-sweep sampler state
    metrics: Dict[str, torch.Tensor]   # rmse_train_<b> / alpha_<b>
    chain_metrics: Optional[Dict[str, torch.Tensor]] = None


_PRIORS = {"normal": NormalPrior, "spikeandslab": SpikeAndSlabPrior,
           "fixednormal": FixedNormalPrior}


def resolve_chains(chains: Optional[int] = None) -> int:
    """Validate the chain count, defaulting from the ``REPRO_CHAINS``
    environment variable, else 1."""
    if chains is None:
        chains = int(os.environ.get("REPRO_CHAINS", "1"))
    chains = int(chains)
    if chains < 1:
        raise ValueError(f"chains must be >= 1, got {chains}")
    return chains


def _prior_by_name(name: str, num_latent: int):
    if name not in _PRIORS:
        raise ValueError(
            f"unknown prior {name!r}; valid priors: "
            f"{', '.join(sorted(_PRIORS))} (side information selects "
            "the macau prior automatically)")
    return _PRIORS[name](num_latent)


# ---------------------------------------------------------------------------
# the declarative builder
# ---------------------------------------------------------------------------

class ModelBuilder:
    """Compose an entity/block graph, validated eagerly.

    * ``add_entity(name, n, prior="normal", side_info=None)`` declares
      a latent-factor entity; ``prior`` is a registry name ("normal",
      "spikeandslab", "fixednormal") or a prior instance, and
      ``side_info`` (an (n, D) feature matrix) selects the Macau prior
      with a sampled link matrix instead;
    * ``add_block(ent_a, ent_b, data, noise=..., test=..., mask=None)``
      relates two entities through a ``SparseMatrix``, a ``DenseBlock``
      or a dense ndarray (optionally with ``mask=``); ``test=(i, j, v)``
      attaches test triplets evaluated by posterior-mean prediction.

    ``device`` (default: the card) is where the chain runs; sparse and
    ``DenseBlock`` data must already live there, dense arrays and side
    information (numpy arrays or tensors) are moved there.
    ``bf16_gather`` is the reference's ``ModelDef.bf16_gather``: the
    fixed factor of every half-sweep gathered (and, sharded, exchanged)
    as bf16.
    """

    def __init__(self, num_latent: int = 16, device: DeviceLike = None,
                 bf16_gather: bool = False):
        self.num_latent = num_latent
        self.device = resolve_device(device)
        self.bf16_gather = bf16_gather
        self._entities: List[Tuple[str, int, Any,
                                   Optional[torch.Tensor]]] = []
        self._blocks: List[Tuple[str, str, Any, Any,
                                 Optional[TestSet]]] = []

    # -- entities ----------------------------------------------------------

    def _names(self) -> List[str]:
        return [name for name, *_ in self._entities]

    def add_entity(self, name: str, n: int,
                   prior: Union[str, Any] = "normal",
                   side_info: Optional[np.ndarray] = None,
                   beta_precision: float = 5.0,
                   sample_beta_precision: bool = True) -> "ModelBuilder":
        if name in self._names():
            raise ValueError(
                f"duplicate entity {name!r}; entities already added: "
                f"{', '.join(self._names())}")
        n = int(n)
        if n <= 0:
            raise ValueError(f"entity {name!r} needs n > 0, got {n}")
        side = None
        if side_info is not None:
            if not isinstance(prior, str) or prior != "normal":
                raise ValueError(
                    f"entity {name!r}: pass either prior= or "
                    "side_info=, not both — side information selects "
                    "the macau prior automatically")
            if isinstance(side_info, torch.Tensor):
                side = side_info.to(device=self.device,
                                    dtype=torch.float32).contiguous()
            else:
                side = torch.from_numpy(np.ascontiguousarray(
                    np.asarray(side_info, np.float32))).to(self.device)
            if side.dim() != 2 or side.shape[0] != n:
                raise ValueError(
                    f"entity {name!r} side_info must be ({n}, D), got "
                    f"{tuple(side.shape)}")
            p = MacauPrior(self.num_latent, side.shape[1],
                           beta_precision=beta_precision,
                           sample_beta_precision=sample_beta_precision)
        elif isinstance(prior, str):
            p = _prior_by_name(
                prior.replace("-", "").replace("_", "").lower(),
                self.num_latent)
        else:
            p = prior
            pk = getattr(p, "num_latent", None)
            if pk is not None and pk != self.num_latent:
                raise ValueError(
                    f"entity {name!r} prior {type(p).__name__} has "
                    f"num_latent={pk}, but the builder composes a "
                    f"num_latent={self.num_latent} model")
        self._entities.append((name, n, p, side))
        return self

    # -- blocks ------------------------------------------------------------

    def _entity_index(self, name: str) -> int:
        names = self._names()
        if name not in names:
            known = ", ".join(names) if names else "(none yet)"
            raise ValueError(
                f"unknown entity {name!r}; entities added so far: "
                f"{known} — add_entity first")
        return names.index(name)

    def add_block(self, row_entity: str, col_entity: str, data,
                  noise: Any = None, test=None,
                  mask: Optional[np.ndarray] = None) -> "ModelBuilder":
        ri = self._entity_index(row_entity)
        ci = self._entity_index(col_entity)
        if ri == ci:
            raise ValueError(
                f"block {row_entity!r} x {col_entity!r} relates an "
                "entity to itself; blocks must relate two distinct "
                "entities")
        for r2, c2, *_ in self._blocks:
            if {r2, c2} == {row_entity, col_entity}:
                raise ValueError(
                    f"duplicate block {row_entity!r} x {col_entity!r}: "
                    f"the pair already carries the {r2!r} x {c2!r} "
                    "block (one observed matrix per entity pair)")
        if isinstance(data, (SparseMatrix, DenseBlock)):
            if mask is not None:
                raise ValueError("mask= only applies to raw dense "
                                 "ndarray data")
            payload = data
            if payload.device != self.device:
                raise ValueError(
                    f"block {row_entity!r} x {col_entity!r} data is on "
                    f"{payload.device}, the builder runs on {self.device}")
        else:
            payload = dense_block(data, mask, device=self.device)
        want = (self._entities[ri][1], self._entities[ci][1])
        got = tuple(payload.shape)
        if got != want:
            raise ValueError(
                f"block {row_entity!r} x {col_entity!r} data has shape "
                f"{got}, expected {want} "
                f"({row_entity}={want[0]} rows x {col_entity}={want[1]}"
                " cols)")
        ts = None
        if test is not None:
            ts = test if isinstance(test, TestSet) else make_test_set(
                *test, device=self.device)
        self._blocks.append((row_entity, col_entity, payload,
                             noise if noise is not None
                             else FixedGaussian(5.0), ts))
        return self

    # -- build -------------------------------------------------------------

    def build(self) -> Tuple[ModelDef, MFData, Dict[int, TestSet]]:
        """(ModelDef, MFData, {block_index: TestSet}) for the engine."""
        if not self._entities:
            raise ValueError("empty model: add_entity at least two "
                             "entities and add_block a matrix")
        if not self._blocks:
            raise ValueError(
                "model has no blocks: add_block at least one observed "
                f"matrix between entities {', '.join(self._names())}")
        ents = tuple(EntityDef(name, n, prior)
                     for name, n, prior, _ in self._entities)
        blocks = tuple(
            BlockDef(self._entity_index(r), self._entity_index(c),
                     noise, isinstance(payload, SparseMatrix))
            for r, c, payload, noise, _ in self._blocks)
        model = ModelDef(ents, blocks, self.num_latent, self.device,
                         bf16_gather=self.bf16_gather)
        data = with_side_grams(MFData(
            tuple(p for _, _, p, _, _ in self._blocks),
            tuple(s for *_, s in self._entities)))
        tests = {bi: ts for bi, (*_, ts) in enumerate(self._blocks)
                 if ts is not None}
        return model, data, tests

    def session(self, **kwargs) -> "Session":
        model, data, tests = self.build()
        return Session(model, data, tests=tests, **kwargs)


# ---------------------------------------------------------------------------
# the run loop
# ---------------------------------------------------------------------------

class Session:
    """Run Gibbs chains over a built model graph.

    * ``chains=C`` runs C chains through ``gibbs.multi_chain_step`` (a
      loop: chain c is bitwise the single-chain run keyed
      ``chain_keys(seed, C)[c]``); ``None`` defers to ``REPRO_CHAINS``.
      Test metrics pool the chains' draws, and split-R-hat / bulk-ESS
      over the per-chain traces land in ``SessionResult.diagnostics``.
    * ``save_freq=k`` streams every k-th post-burnin state to
      ``save_dir`` (``model.json`` + ``samples/step_<sweep+1>/``; for
      C > 1 one such store a chain under ``chain_<c>/`` below a
      top-level ``model.json`` whose ``run.chains`` is C) and writes
      ``diagnostics.json`` at the end; ``run(resume=True)`` continues
      from the newest step every chain has on disk.
    * ``init_transform`` maps each chain's fresh state before the first
      sweep; ``accumulate_factor_means`` averages every entity's factor
      over the posterior draws (``SessionResult.factor_means``).
    * ``callbacks`` are called after every sweep with a
      :class:`SweepInfo`; ``verbose`` prints chain 0's train RMSE about
      twenty times a run.
    * ``recorder`` (None: a fresh one, enabled by ``REPRO_OBS=1``) is
      shared with the checkpoint savers and records the sweep spans.
    * ``mesh`` (a ``DeviceMesh``; every rank of the world runs the
      session) runs the distributed sweep, ``pipeline`` ("eager" or
      "ring", None: ``REPRO_PIPELINE``) chooses its exchange and
      ``chain_axis`` splits the chains over a mesh dim.  The whole
      state is gathered at the sweeps that accumulate, keep, store or
      call back, and at the last; rank 0 writes the store.
    """

    def __init__(self, model: ModelDef, data: MFData, *,
                 tests: Optional[Dict[int, TestSet]] = None,
                 burnin: int = 100, nsamples: int = 100, seed: int = 0,
                 mesh: Any = None, pipeline: Optional[str] = None,
                 chains: Optional[int] = None,
                 chain_axis: Optional[str] = None,
                 save_freq: int = 0, save_dir: Optional[str] = None,
                 verbose: int = 0,
                 callbacks: Sequence[Callable[[SweepInfo], None]] = (),
                 init_transform: Optional[Callable[[MFState],
                                                   MFState]] = None,
                 accumulate_factor_means: bool = False,
                 recorder: Any = None):
        _check_mesh(mesh, pipeline, chain_axis)
        self.model = model
        self.data = data
        self.tests = dict(tests or {})
        for bi in self.tests:
            if not 0 <= bi < len(model.blocks):
                raise ValueError(
                    f"test set attached to block {bi}, but the model "
                    f"has blocks 0..{len(model.blocks) - 1}")
        self.burnin = burnin
        self.nsamples = nsamples
        self.seed = seed
        self.mesh = mesh
        self.pipeline = pipeline
        self.chains = resolve_chains(chains)
        self.chain_axis = chain_axis
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.verbose = verbose
        self.callbacks = tuple(callbacks)
        self.init_transform = init_transform
        self.accumulate_factor_means = accumulate_factor_means
        # None -> a fresh Recorder at run() time, enabled iff
        # REPRO_OBS=1; an explicit one is shared with the savers
        self.recorder = recorder
        if save_freq and not save_dir:
            raise ValueError(
                "save_freq > 0 streams posterior samples to disk; "
                "pass save_dir= too")

    # -- persistence -------------------------------------------------------

    def _run_spec(self, chain: Optional[int] = None) -> dict:
        run = {"burnin": self.burnin, "nsamples": self.nsamples,
               "save_freq": self.save_freq, "seed": self.seed,
               "chains": self.chains}
        if chain is not None:
            run["chain"] = chain
        return run

    def _spec_at(self, directory: str, chain: Optional[int] = None):
        from .modelspec import (MODEL_SPEC_FILE, model_to_spec,
                                save_model_spec)
        os.makedirs(directory, exist_ok=True)
        spec = model_to_spec(self.model)
        spec["run"] = self._run_spec(chain)
        save_model_spec(os.path.join(directory, MODEL_SPEC_FILE), spec)

    def _make_savers(self, recorder=None, write: bool = True):
        """One ``CheckpointManager`` a chain, ``keep=None`` (a
        posterior-sample store retains every step).  One chain keeps
        the single-chain layout (``save_dir/model.json`` +
        ``save_dir/samples/``); C > 1 nests a single-chain store a chain
        under ``save_dir/chain_<c>/``.  ``write=False`` (a rank other
        than 0) writes no ``model.json``: its savers only restore."""
        from ..checkpoint import CheckpointManager
        from .modelspec import SAMPLES_SUBDIR, chain_subdir
        if write:
            self._spec_at(self.save_dir)
        if self.chains == 1:
            return [CheckpointManager(
                os.path.join(self.save_dir, SAMPLES_SUBDIR), keep=None,
                recorder=recorder)]
        savers = []
        for c in range(self.chains):
            cdir = os.path.join(self.save_dir, chain_subdir(c))
            if write:
                self._spec_at(cdir, chain=c)
            savers.append(CheckpointManager(
                os.path.join(cdir, SAMPLES_SUBDIR), keep=None,
                recorder=recorder))
        return savers

    def _restore(self, savers, state: MFState):
        """(start, state) from the newest step every chain has on disk,
        or None when a chain's store is empty.  One chain: its latest
        complete step; several: the highest step common to all (an
        interrupted run can leave chains one save apart, and every
        earlier step is kept)."""
        if self.chains == 1:
            return savers[0].restore_latest(state)
        common = None
        for sv in savers:
            steps = set(sv.all_steps())
            common = steps if common is None else (common & steps)
        if not common:
            return None
        step = max(common)
        chains = [sv.restore_step(unstack_state(state, c), step)
                  for c, sv in enumerate(savers)]
        return step, stack_states(chains)

    # -- run ---------------------------------------------------------------

    def _wire_bytes(self, dstep) -> int:
        """Bytes a rank receives a sweep by the communication contract
        (``analysis.contract``), the ``bytes_on_wire`` of every sweep
        span: 0 on one card and where every rank runs the whole
        sweep."""
        if dstep is None or not dstep.supported:
            return 0
        from ..analysis.contract import contract_for, contract_wire_bytes
        from .distributed import _dim_size
        c = contract_for(
            self.model, tuple(int(n) for n in self.mesh.mesh.shape),
            self.pipeline, chains=self.chains,
            chain_axis_size=(None if self.chain_axis is None
                             else _dim_size(self.mesh, self.chain_axis)))
        return contract_wire_bytes(self.model, c)

    def _export_obs(self, rec) -> None:
        """Write the run's trace and metrics snapshots when the recorder
        is enabled: to ``REPRO_OBS_DIR`` if set, else ``save_dir/obs``
        when the session streams samples, else nowhere (the caller owns
        the export)."""
        if not rec.enabled:
            return
        dest = os.environ.get("REPRO_OBS_DIR")
        if dest is None and self.save_dir:
            dest = os.path.join(self.save_dir, "obs")
        if dest is None:
            return
        rec.write_trace(os.path.join(dest, "train_trace.json"))
        rec.write_metrics(os.path.join(dest, "train_metrics.json"))

    def _init(self) -> MFState:
        model, data, C = self.model, self.data, self.chains
        if C == 1:
            state = init_state(model, data, self.seed)
            if self.init_transform is not None:
                state = self.init_transform(state)
            return state
        chain_states = init_chain_states(model, data, self.seed, C)
        if self.init_transform is not None:
            chain_states = [self.init_transform(s) for s in chain_states]
        return stack_states(chain_states)

    def run(self, keep_samples: bool = False,
            resume: bool = False) -> SessionResult:
        model, data = self.model, self.data
        dev = model.device
        rec = resolve_recorder(self.recorder)
        rec.set_kind("session")
        C = self.chains
        state = self._init()
        rank0 = True
        if self.mesh is not None:
            import torch.distributed as dist
            rank0 = dist.get_rank() == 0

        savers = []
        start = 0
        resumed_from: Optional[int] = None
        if self.save_freq:
            savers = self._make_savers(recorder=rec, write=rank0)
            if resume:
                restored = self._restore(savers, state)
                if restored is not None:
                    start, state = restored
                    resumed_from = start
        elif resume:
            raise ValueError(
                "resume=True needs save_freq > 0 and a save_dir "
                "holding the interrupted chain's samples")

        dstep, data_run, state_run = _place_step(
            model, data, state, self.mesh, self.pipeline, C,
            self.chain_axis)
        step = dstep if dstep is not None else functools.partial(
            gibbs_step if C == 1 else multi_chain_step, model)

        accs = {bi: PredictAccumulator(ts) for bi, ts in self.tests.items()}
        total = self.burnin + self.nsamples
        compile_s = 0.0
        if start < total and dev.type == "cuda":
            from ..kernels import _build
            t_c = clock.perf_counter()
            _build.build_all()
            compile_s = clock.perf_counter() - t_c
            rec.complete("session/compile", t_c, cat="session",
                         phase="compile")
        obs_on = rec.enabled
        bytes_on_wire = self._wire_bytes(dstep) if obs_on else 0
        n_blocks = len(model.blocks)
        train_traces: List[List[float]] = [[] for _ in range(n_blocks)]
        chain_train_traces: List[List[List[float]]] = [
            [[] for _ in range(n_blocks)] for _ in range(C)]
        test_traces: Dict[int, List[float]] = {bi: [] for bi in self.tests}
        samples: List[Tuple[np.ndarray, ...]] = []
        sums = None
        if self.accumulate_factor_means:
            lead = () if C == 1 else (C,)
            sums = [torch.zeros(lead + (e.n_rows, model.num_latent),
                                device=dev) for e in model.entities]
        n_acc = 0
        # post-burnin traces of the monitored scalars, (C,) a sweep, for
        # split-R-hat and bulk-ESS at the end of the run
        diag_traces: Dict[str, List[np.ndarray]] = {}

        synchronize(dev)
        t0 = clock.perf_counter()
        for sweep in range(start, total):
            if obs_on:
                t_sweep = rec.now()
            state_run, metrics = step(data_run, state_run)
            if obs_on:
                # fence: the sweep's device time, not its dispatch time
                synchronize(dev)
                t_done = rec.now()
            in_sampling = sweep >= self.burnin
            if dstep is None:
                state = state_run
            else:
                # every chain's metrics, and the whole state where the
                # loop reads it (counted apart from the sweep's census)
                metrics = dstep.gather_metrics(metrics)
                if in_sampling or self.callbacks or sweep == total - 1:
                    state = dstep.gather_state(state_run)
            for bi in range(n_blocks):
                arr = np.atleast_1d(
                    metrics[f"rmse_train_{bi}"].cpu().numpy())
                train_traces[bi].append(float(arr[0]))
                for c in range(C):
                    chain_train_traces[c][bi].append(float(arr[c]))
            if in_sampling:
                # pool the chains' draws step-major, chain-minor: the
                # order PredictSession replays from a multi-chain store
                for bi, acc in accs.items():
                    blk = model.blocks[bi]
                    if C == 1:
                        acc.update(state.factors[blk.row_entity],
                                   state.factors[blk.col_entity])
                    else:
                        for c in range(C):
                            acc.update(state.factors[blk.row_entity][c],
                                       state.factors[blk.col_entity][c])
                    test_traces[bi].append(float(torch.sqrt(torch.mean(
                        (acc.mean - acc.test.v) ** 2))))
                if keep_samples:
                    if C == 1:
                        samples.append(tuple(f.cpu().numpy()
                                             for f in state.factors))
                    else:
                        for c in range(C):
                            samples.append(tuple(f[c].cpu().numpy()
                                                 for f in state.factors))
                if sums is not None:
                    sums = [s + f for s, f in zip(sums, state.factors)]
                    n_acc += 1
                for nm, v in metrics.items():
                    diag_traces.setdefault(nm, []).append(np.atleast_1d(
                        v.cpu().numpy().astype(np.float64)))
                for e, ent in enumerate(model.entities):
                    f = state.factors[e]
                    rms = torch.sqrt(torch.mean(f * f)) if C == 1 else \
                        torch.sqrt(torch.mean(f * f, dim=(1, 2)))
                    diag_traces.setdefault(
                        f"factor_rms_{ent.name}", []).append(np.atleast_1d(
                            rms.cpu().numpy().astype(np.float64)))
                if savers and rank0 and \
                        (sweep - self.burnin + 1) % self.save_freq == 0:
                    if C == 1:
                        savers[0].save(sweep + 1, state)
                    else:
                        for c, sv in enumerate(savers):
                            sv.save(sweep + 1, unstack_state(state, c))
            if obs_on:
                span_args = {
                    "sweep": sweep,
                    "phase": "sample" if in_sampling else "burnin",
                    "stage": "first" if sweep == start else "steady",
                    # bytes a rank receives a sweep, by the contract
                    "bytes_on_wire": bytes_on_wire,
                }
                tr = diag_traces.get("rmse_train_0")
                if tr:
                    # streaming convergence: split-R-hat over the
                    # post-burnin draws so far (nan below its minimum)
                    rhat = split_rhat(np.stack(tr, axis=1))
                    if np.isfinite(rhat):
                        span_args["rhat_rmse_train_0"] = rhat
                rec.complete("sweep", t_sweep, end=t_done,
                             cat="session", **span_args)
                rec.observe("session.sweep_s", t_done - t_sweep)
                rec.add("session.sweeps")
            if self.verbose and (sweep % max(1, total // 20) == 0):
                ph = "burnin" if sweep < self.burnin else "sample"
                print(f"[{ph} {sweep:4d}] rmse_train="
                      f"{train_traces[0][-1]:.4f}")
            if self.callbacks:
                phase = "sample" if in_sampling else "burnin"
                if C == 1:
                    info = SweepInfo(sweep, phase, state, metrics)
                else:
                    m0 = {k: v[0] for k, v in metrics.items()}
                    info = SweepInfo(sweep, phase, state, m0, metrics)
                for cb in self.callbacks:
                    cb(info)
        for sv in savers:
            sv.wait()

        diag = None
        if diag_traces:
            diag = compute_diagnostics(
                {k: np.stack(v, axis=1) for k, v in diag_traces.items()})
            if savers and rank0:
                save_diagnostics(self.save_dir, diag)
        synchronize(dev)
        runtime = clock.perf_counter() - t0

        names = model.entity_names
        block_results: List[BlockResult] = []
        head: Optional[BlockResult] = None
        for bi, blk in enumerate(model.blocks):
            acc = accs.get(bi)
            if acc is not None and acc.n == 0:
                acc = None   # resumed past the end: nothing accumulated
            is_probit = isinstance(blk.noise, ProbitNoise)
            br = BlockResult(
                block=bi,
                entities=(names[blk.row_entity], names[blk.col_entity]),
                rmse_train_trace=train_traces[bi],
                rmse_test_trace=test_traces.get(bi, []),
                rmse_test=(acc.rmse() if acc else None),
                auc_test=(acc.auc() if (acc and is_probit) else None),
                predictions=(acc.mean.cpu().numpy() if acc else None),
                pred_var=(acc.var.cpu().numpy() if acc else None))
            block_results.append(br)
            if head is None and acc is not None:
                head = br
        if head is None:
            head = block_results[0]
        chain_blocks = None
        if C > 1:
            chain_blocks = [
                [BlockResult(
                    block=bi,
                    entities=(names[blk.row_entity],
                              names[blk.col_entity]),
                    rmse_train_trace=chain_train_traces[c][bi],
                    rmse_test_trace=[], rmse_test=None, auc_test=None,
                    predictions=None, pred_var=None)
                 for bi, blk in enumerate(model.blocks)]
                for c in range(C)]
        means = None
        if sums is not None:
            if n_acc == 0 and self.nsamples > 0:
                raise ValueError(
                    f"run(resume=True) restored the chain at {start} "
                    "completed sweeps — at or past the end of the "
                    f"burnin={self.burnin} + nsamples={self.nsamples} "
                    f"= {total} schedule — so ZERO posterior draws "
                    "were accumulated and factor_means would be "
                    "silently all-zero. The schedule counts TOTAL "
                    "sweeps, not additional ones: raise nsamples to "
                    "extend the chain, or rerun without resume=True.")
            means = [(s / max(n_acc, 1)).cpu().numpy() for s in sums]
        rec.gauge("session.chains", C)
        if rank0:
            self._export_obs(rec)
        return SessionResult(
            rmse_test=head.rmse_test,
            auc_test=head.auc_test,
            predictions=head.predictions,
            pred_var=head.pred_var,
            rmse_train_trace=train_traces[0],
            rmse_test_trace=head.rmse_test_trace,
            nsamples=self.nsamples,
            runtime_s=runtime,
            compile_s=compile_s,
            state=state,
            samples=samples if keep_samples else None,
            blocks=block_results,
            factor_means=means,
            save_dir=self.save_dir,
            n_chains=C,
            chain_blocks=chain_blocks,
            diagnostics=diag,
            resumed_from=resumed_from,
        )


# ---------------------------------------------------------------------------
# the classic shapes, as thin wrappers over the builder
# ---------------------------------------------------------------------------

class TrainSession:
    """Single-R-matrix session (BMF / Macau / probit variants): two
    entities ("rows", "cols") and one block, composed through
    :class:`ModelBuilder` exactly as the reference's ``TrainSession``
    composes it, so its chain is the builder's.  ``device`` takes the
    place of the reference's ``use_pallas``; the other arguments are
    :class:`Session`'s."""

    def __init__(self, num_latent: int = 16, burnin: int = 100,
                 nsamples: int = 100, seed: int = 0,
                 priors: Sequence[str] = ("normal", "normal"),
                 device: DeviceLike = None, verbose: int = 0,
                 save_freq: int = 0, save_dir: Optional[str] = None,
                 mesh: Any = None, pipeline: Optional[str] = None,
                 chains: Optional[int] = None,
                 chain_axis: Optional[str] = None,
                 callbacks: Sequence[Callable[[SweepInfo], None]] = (),
                 recorder: Any = None):
        _check_mesh(mesh, pipeline, chain_axis)
        self.num_latent = num_latent
        self.burnin = burnin
        self.nsamples = nsamples
        self.seed = seed
        self.recorder = recorder
        self.prior_names = tuple(p.replace("-", "").replace("_", "")
                                 for p in priors)
        self.device = resolve_device(device)
        self.verbose = verbose
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.mesh = mesh
        self.pipeline = pipeline
        self.chains = chains
        self.chain_axis = chain_axis
        self.callbacks = callbacks
        self._train: Optional[Any] = None
        self._test: Optional[TestSet] = None
        self._noise: Any = FixedGaussian(5.0)
        self._sides: List[Optional[np.ndarray]] = [None, None]
        # per axis: side information on both axes keeps each one's knobs
        self._beta_precisions: List[float] = [5.0, 5.0]
        self._sample_beta_precisions: List[bool] = [True, True]

    def add_train_and_test(self, train, test=None, noise=None):
        """train: SparseMatrix | DenseBlock | dense np.ndarray (fully
        observed); test: (i, j, v)."""
        if isinstance(train, np.ndarray):
            train = dense_block(train, device=self.device)
        self._train = train
        if test is not None:
            self._test = make_test_set(*test, device=self.device)
        if noise is not None:
            self._noise = noise
        return self

    def add_side_info(self, axis: int, F: np.ndarray,
                      beta_precision: float = 5.0,
                      sample_beta_precision: bool = True):
        """Attach side information to rows (axis=0) or cols (axis=1):
        that entity takes the Macau prior."""
        if axis not in (0, 1):
            raise ValueError(
                f"unknown axis {axis!r}; valid axes: (0, 1) — 0 rows, "
                "1 cols")
        self._sides[axis] = np.asarray(F, np.float32)
        self._beta_precisions[axis] = beta_precision
        self._sample_beta_precisions[axis] = sample_beta_precision
        return self

    def _builder(self) -> ModelBuilder:
        if self._train is None:
            raise ValueError("call add_train_and_test first")
        n_rows, n_cols = self._train.shape
        b = ModelBuilder(self.num_latent, self.device)
        for axis, (name, n) in enumerate((("rows", n_rows),
                                          ("cols", n_cols))):
            side = self._sides[axis]
            if side is not None:
                b.add_entity(
                    name, n, side_info=side,
                    beta_precision=self._beta_precisions[axis],
                    sample_beta_precision=self._sample_beta_precisions[
                        axis])
            else:
                b.add_entity(name, n, prior=self.prior_names[axis])
        b.add_block("rows", "cols", self._train, noise=self._noise,
                    test=self._test)
        return b

    def _build(self) -> Tuple[ModelDef, MFData]:
        """(ModelDef, MFData) of the session's graph."""
        model, data, _ = self._builder().build()
        return model, data

    def run(self, keep_samples: bool = False,
            resume: bool = False) -> SessionResult:
        sess = self._builder().session(
            burnin=self.burnin, nsamples=self.nsamples, seed=self.seed,
            mesh=self.mesh, pipeline=self.pipeline, chains=self.chains,
            chain_axis=self.chain_axis, save_freq=self.save_freq,
            save_dir=self.save_dir, verbose=self.verbose,
            callbacks=self.callbacks, recorder=self.recorder)
        return sess.run(keep_samples=keep_samples, resume=resume)


class GFASession:
    """Group Factor Analysis: M dense views sharing a sample entity.

    ``views`` are (N, D_m) arrays (numpy, or tensors, which stay on the
    card).  The shared entity takes a FixedNormal prior and each view's
    loadings the spike-and-slab prior (paper Table 1, GFA row), composed
    through :class:`ModelBuilder` as the reference composes them, so the
    chain is the reference's.  The run accumulates factor means;
    ``zero_init_loadings`` (default) starts every loading at zero, so
    the components switch on one by one.  For C > 1, ``Z``/``W``
    follow chain 0 (the chains' modes differ by a rotation, so their
    loadings do not pool) and ``Z_chains``/``W_chains`` hold every
    chain's means.
    """

    def __init__(self, views: Sequence[Any], num_latent: int = 8,
                 burnin: int = 200, nsamples: int = 200, seed: int = 0,
                 noise: Any = None, device: DeviceLike = None,
                 zero_init_loadings: bool = True, mesh: Any = None,
                 pipeline: Optional[str] = None,
                 chains: Optional[int] = None,
                 chain_axis: Optional[str] = None,
                 save_freq: int = 0, save_dir: Optional[str] = None,
                 callbacks: Sequence[Callable[[SweepInfo], None]] = (),
                 recorder: Any = None):
        _check_mesh(mesh, pipeline, chain_axis)
        self.device = resolve_device(device)
        self.views = [v if isinstance(v, torch.Tensor)
                      else np.asarray(v, np.float32) for v in views]
        self.recorder = recorder
        self.num_latent = num_latent
        self.burnin = burnin
        self.nsamples = nsamples
        self.seed = seed
        self.noise = noise or AdaptiveGaussian()
        self.zero_init_loadings = zero_init_loadings
        self.mesh = mesh
        self.pipeline = pipeline
        self.chains = chains
        self.chain_axis = chain_axis
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.callbacks = callbacks

    def _builder(self) -> ModelBuilder:
        N = self.views[0].shape[0]
        b = ModelBuilder(self.num_latent, self.device)
        b.add_entity("samples", N, prior=FixedNormalPrior(self.num_latent))
        for m, X in enumerate(self.views):
            b.add_entity(f"view{m}", X.shape[1],
                         prior=SpikeAndSlabPrior(self.num_latent))
            b.add_block("samples", f"view{m}", X, noise=self.noise)
        return b

    def _build(self) -> Tuple[ModelDef, MFData]:
        model, data, _ = self._builder().build()
        return model, data

    @staticmethod
    def _zero_loadings(state: MFState) -> MFState:
        fs = list(state.factors)
        for e in range(1, len(fs)):
            fs[e] = torch.zeros_like(fs[e])
        return state._replace(factors=tuple(fs))

    def run(self, resume: bool = False) -> Dict[str, Any]:
        sess = self._builder().session(
            burnin=self.burnin, nsamples=self.nsamples, seed=self.seed,
            mesh=self.mesh, pipeline=self.pipeline, chains=self.chains,
            chain_axis=self.chain_axis, save_freq=self.save_freq,
            save_dir=self.save_dir, callbacks=self.callbacks,
            recorder=self.recorder,
            init_transform=(self._zero_loadings
                            if self.zero_init_loadings else None),
            accumulate_factor_means=True)
        r = sess.run(resume=resume)
        if r.n_chains > 1:
            out = {
                "Z": r.factor_means[0][0],
                "W": [m[0] for m in r.factor_means[1:]],
                "Z_last": r.state.factors[0][0].cpu().numpy(),
                "W_last": [f[0].cpu().numpy()
                           for f in r.state.factors[1:]],
                "Z_chains": r.factor_means[0],
                "W_chains": r.factor_means[1:],
            }
        else:
            out = {
                "Z": r.factor_means[0],
                "W": r.factor_means[1:],
                "Z_last": r.state.factors[0].cpu().numpy(),
                "W_last": [f.cpu().numpy() for f in r.state.factors[1:]],
            }
        out.update({
            "rmse_train": [b.rmse_train_trace for b in r.blocks],
            "runtime_s": r.runtime_s,
            "compile_s": r.compile_s,
            "state": r.state,
            "diagnostics": r.diagnostics,
            "result": r,
        })
        return out


def smurff(train, test=None, side_info=(None, None), num_latent=16,
           burnin=100, nsamples=100, noise=None, seed=0,
           device: DeviceLike = None, verbose=0, mesh=None, pipeline=None,
           chains=None, chain_axis=None,
           save_freq=0, save_dir=None) -> SessionResult:
    """One-call API (the reference's ``smurff(...)``, with ``device=``
    where it has ``use_pallas=``): a :class:`TrainSession` over
    ``train``, with side information per axis, run once."""
    sess = TrainSession(num_latent=num_latent, burnin=burnin,
                        nsamples=nsamples, seed=seed, device=device,
                        verbose=verbose, mesh=mesh, pipeline=pipeline,
                        chains=chains, chain_axis=chain_axis,
                        save_freq=save_freq, save_dir=save_dir)
    sess.add_train_and_test(train, test=test, noise=noise)
    for axis, F in enumerate(side_info):
        if F is not None:
            sess.add_side_info(axis, F)
    return sess.run()
