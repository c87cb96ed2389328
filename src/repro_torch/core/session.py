"""Session API: compose a model, run one Gibbs chain.

The counterpart of ``repro/core/session.py`` for the slice the port
covers: ``ModelBuilder``, ``Session``, ``SessionResult``/``BlockResult``
and ``TrainSession``, for one chain with Normal priors, sparse blocks
and Fixed/Adaptive Gaussian noise:

    b = ModelBuilder(num_latent=128)            # device="cuda" implied
    b.add_entity("compound", n_compounds)
    b.add_entity("protein", n_proteins)
    b.add_block("compound", "protein", train, test=(i, j, v),
                noise=AdaptiveGaussian())
    result = b.session(burnin=4, nsamples=2, seed=0).run()

``save_freq=k`` with ``save_dir`` streams every k-th post-burnin sample
to disk in the reference's store layout (``model.json`` plus
``samples/step_<sweep>/``), and the run's split-R-hat and bulk-ESS go
to ``diagnostics.json``; ``PredictSession`` serves such a store.

Every option outside the slice (side information, other priors, probit,
dense data, ``chains > 1``, ``mesh``, ``resume``) raises a ValueError
that names what the port supports; ROADMAP.md queues the rest.  Errors
the two packages share carry the reference's messages.

Where the reference runs a discarded warm-up sweep to split jit
compilation from sweep time, the port has nothing to compile but its
CUDA kernels: ``compile_s`` is the time to build them (zero when they
are built already, and on the CPU).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from .._device import DeviceLike, resolve_device, synchronize
from .blocks import BlockDef, EntityDef, ModelDef
from .diagnostics import Diagnostics, compute_diagnostics, save_diagnostics
from .gibbs import MFData, MFState, gibbs_step, init_state
from .noise import AdaptiveGaussian, FixedGaussian
from .predict import PredictAccumulator, TestSet, make_test_set
from .priors import NormalPrior
from .sparse import SparseMatrix

_SUPPORTED = ("the port supports one chain with Normal priors, sparse "
              "blocks and FixedGaussian/AdaptiveGaussian noise; see "
              "ROADMAP.md, queue A, for what is still to be ported")


def _unsupported(what: str) -> ValueError:
    return ValueError(f"{what} is not ported yet: {_SUPPORTED}")


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
    """Result of one run.  The scalar fields mirror the first block
    carrying a test set; ``blocks`` holds every block's traces."""

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
    save_dir: Optional[str] = None
    n_chains: int = 1
    diagnostics: Optional[Diagnostics] = None
    compile_s: float = 0.0


class SweepInfo(NamedTuple):
    """What a per-sweep callback sees (after the sweep completed)."""

    sweep: int          # 0-based global sweep index
    phase: str          # "burnin" | "sample"
    state: MFState      # post-sweep sampler state
    metrics: Dict[str, torch.Tensor]   # rmse_train_<b> / alpha_<b>


_PRIORS = {"normal": NormalPrior}
# priors the reference has and the port does not yet
_LATER_PRIORS = ("fixednormal", "spikeandslab")


def _prior_by_name(name: str, num_latent: int):
    if name in _LATER_PRIORS:
        raise _unsupported(f"prior {name!r}")
    if name not in _PRIORS:
        raise ValueError(
            f"unknown prior {name!r}; valid priors: "
            f"{', '.join(sorted(_PRIORS))}")
    return _PRIORS[name](num_latent)


# ---------------------------------------------------------------------------
# the declarative builder
# ---------------------------------------------------------------------------

class ModelBuilder:
    """Compose an entity/block graph, validated eagerly.

    * ``add_entity(name, n, prior="normal")`` declares a latent-factor
      entity;
    * ``add_block(ent_a, ent_b, data, noise=..., test=...)`` relates two
      entities through a ``SparseMatrix``; ``test=(i, j, v)`` attaches
      test triplets evaluated by posterior-mean prediction.

    ``device`` (default: the card) is where the chain runs; the data
    must already live there.
    """

    def __init__(self, num_latent: int = 16, device: DeviceLike = None):
        self.num_latent = num_latent
        self.device = resolve_device(device)
        self._entities: List[Tuple[str, int, Any]] = []
        self._blocks: List[Tuple[str, str, Any, Any,
                                 Optional[TestSet]]] = []

    # -- entities ----------------------------------------------------------

    def _names(self) -> List[str]:
        return [name for name, *_ in self._entities]

    def add_entity(self, name: str, n: int,
                   prior: Union[str, Any] = "normal",
                   side_info: Optional[np.ndarray] = None
                   ) -> "ModelBuilder":
        if name in self._names():
            raise ValueError(
                f"duplicate entity {name!r}; entities already added: "
                f"{', '.join(self._names())}")
        n = int(n)
        if n <= 0:
            raise ValueError(f"entity {name!r} needs n > 0, got {n}")
        if side_info is not None:
            raise _unsupported("side_info (the Macau prior)")
        if isinstance(prior, str):
            p = _prior_by_name(
                prior.replace("-", "").replace("_", "").lower(),
                self.num_latent)
        else:
            p = prior
            if not isinstance(p, NormalPrior):
                raise _unsupported(f"prior {type(p).__name__}")
            if p.num_latent != self.num_latent:
                raise ValueError(
                    f"entity {name!r} prior {type(p).__name__} has "
                    f"num_latent={p.num_latent}, but the builder composes "
                    f"a num_latent={self.num_latent} model")
        self._entities.append((name, n, p))
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
                  noise: Any = None, test=None) -> "ModelBuilder":
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
        if not isinstance(data, SparseMatrix):
            raise _unsupported("dense block data")
        if data.device != self.device:
            raise ValueError(
                f"block {row_entity!r} x {col_entity!r} data is on "
                f"{data.device}, the builder runs on {self.device}")
        if noise is not None and not isinstance(
                noise, (FixedGaussian, AdaptiveGaussian)):
            raise _unsupported(f"noise {type(noise).__name__}")
        want = (self._entities[ri][1], self._entities[ci][1])
        got = tuple(data.shape)
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
        self._blocks.append((row_entity, col_entity, data,
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
                     for name, n, prior in self._entities)
        blocks = tuple(
            BlockDef(self._entity_index(r), self._entity_index(c),
                     noise, True)
            for r, c, _, noise, _ in self._blocks)
        model = ModelDef(ents, blocks, self.num_latent, self.device)
        data = MFData(tuple(p for _, _, p, _, _ in self._blocks),
                      tuple(None for _ in self._entities))
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
    """Run one Gibbs chain over a built model graph.

    ``callbacks`` are called after every sweep with a :class:`SweepInfo`.
    ``save_freq=k`` streams every k-th post-burnin state to ``save_dir``
    (``model.json`` + ``samples/step_<sweep+1>/``, the layout
    ``PredictSession`` reloads) and writes ``diagnostics.json`` at the
    end.  ``mesh``, ``pipeline``, ``chains > 1`` and ``chain_axis``
    exist in the reference and raise here until their slices are
    ported.
    """

    def __init__(self, model: ModelDef, data: MFData, *,
                 tests: Optional[Dict[int, TestSet]] = None,
                 burnin: int = 100, nsamples: int = 100, seed: int = 0,
                 mesh: Any = None, pipeline: Optional[str] = None,
                 chains: Optional[int] = None,
                 chain_axis: Optional[str] = None,
                 save_freq: int = 0, save_dir: Optional[str] = None,
                 callbacks: Sequence[Callable[[SweepInfo], None]] = ()):
        if mesh is not None or pipeline is not None \
                or chain_axis is not None:
            raise _unsupported("the distributed sweep (mesh=, pipeline=, "
                               "chain_axis=)")
        if chains not in (None, 1):
            raise _unsupported(f"chains={chains}")
        if save_freq and not save_dir:
            raise ValueError(
                "save_freq > 0 streams posterior samples to disk; "
                "pass save_dir= too")
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
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.callbacks = tuple(callbacks)

    # -- persistence -------------------------------------------------------

    def _spec_at(self, directory: str) -> None:
        """``model.json`` of the run, as the reference's ``_spec_at``
        writes it for one chain."""
        from .modelspec import (MODEL_SPEC_FILE, model_to_spec,
                                save_model_spec)
        os.makedirs(directory, exist_ok=True)
        spec = model_to_spec(self.model)
        spec["run"] = {"burnin": self.burnin, "nsamples": self.nsamples,
                       "save_freq": self.save_freq, "seed": self.seed,
                       "chains": 1}
        save_model_spec(os.path.join(directory, MODEL_SPEC_FILE), spec)

    def _make_saver(self):
        """The store's ``CheckpointManager``; ``keep=None``, since a
        posterior-sample store retains every step."""
        from ..checkpoint import CheckpointManager
        from .modelspec import SAMPLES_SUBDIR
        self._spec_at(self.save_dir)
        return CheckpointManager(
            os.path.join(self.save_dir, SAMPLES_SUBDIR), keep=None)

    # -- run ---------------------------------------------------------------

    def run(self, keep_samples: bool = False,
            resume: bool = False) -> SessionResult:
        if resume:
            raise _unsupported("resume=True (continuing a save_freq "
                               "store)")
        model, data = self.model, self.data
        dev = model.device
        compile_s = 0.0
        if dev.type == "cuda":
            from ..kernels import _build
            t_c = time.perf_counter()
            _build.build_all()
            compile_s = time.perf_counter() - t_c

        state = init_state(model, data, self.seed)
        saver = self._make_saver() if self.save_freq else None
        accs = {bi: PredictAccumulator(ts) for bi, ts in self.tests.items()}
        total = self.burnin + self.nsamples
        n_blocks = len(model.blocks)
        train_traces: List[List[float]] = [[] for _ in range(n_blocks)]
        test_traces: Dict[int, List[float]] = {bi: [] for bi in self.tests}
        samples: List[Tuple[np.ndarray, ...]] = []
        # post-burnin traces of the monitored scalars, for split-R-hat
        # and bulk-ESS at the end of the run
        diag_traces: Dict[str, List[float]] = {}

        synchronize(dev)
        t0 = time.perf_counter()
        for sweep in range(total):
            state, metrics = gibbs_step(model, data, state)
            for bi in range(n_blocks):
                train_traces[bi].append(float(metrics[f"rmse_train_{bi}"]))
            in_sampling = sweep >= self.burnin
            if in_sampling:
                for bi, acc in accs.items():
                    blk = model.blocks[bi]
                    acc.update(state.factors[blk.row_entity],
                               state.factors[blk.col_entity])
                    test_traces[bi].append(float(torch.sqrt(torch.mean(
                        (acc.mean - acc.test.v) ** 2))))
                if keep_samples:
                    samples.append(tuple(f.cpu().numpy()
                                         for f in state.factors))
                for nm, v in metrics.items():
                    diag_traces.setdefault(nm, []).append(float(v))
                for e, ent in enumerate(model.entities):
                    f = state.factors[e]
                    diag_traces.setdefault(
                        f"factor_rms_{ent.name}", []).append(
                        float(torch.sqrt(torch.mean(f * f))))
                if saver is not None and \
                        (sweep - self.burnin + 1) % self.save_freq == 0:
                    saver.save(sweep + 1, state)
            if self.callbacks:
                phase = "sample" if in_sampling else "burnin"
                info = SweepInfo(sweep, phase, state, metrics)
                for cb in self.callbacks:
                    cb(info)
        if saver is not None:
            saver.wait()

        diag = None
        if diag_traces:
            diag = compute_diagnostics(
                {k: np.asarray(v, np.float64)[None, :]
                 for k, v in diag_traces.items()})
            if saver is not None:
                save_diagnostics(self.save_dir, diag)
        synchronize(dev)
        runtime = time.perf_counter() - t0

        names = model.entity_names
        block_results: List[BlockResult] = []
        head: Optional[BlockResult] = None
        for bi, blk in enumerate(model.blocks):
            acc = accs.get(bi)
            if acc is not None and acc.n == 0:
                acc = None
            br = BlockResult(
                block=bi,
                entities=(names[blk.row_entity], names[blk.col_entity]),
                rmse_train_trace=train_traces[bi],
                rmse_test_trace=test_traces.get(bi, []),
                rmse_test=(acc.rmse() if acc else None),
                auc_test=None,
                predictions=(acc.mean.cpu().numpy() if acc else None),
                pred_var=(acc.var.cpu().numpy() if acc else None))
            block_results.append(br)
            if head is None and acc is not None:
                head = br
        if head is None:
            head = block_results[0]
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
            save_dir=self.save_dir,
            diagnostics=diag,
        )


# ---------------------------------------------------------------------------
# the classic shape, as a thin wrapper over the builder
# ---------------------------------------------------------------------------

class TrainSession:
    """Single-R-matrix session (BMF): two entities ("rows", "cols") and
    one block, composed through :class:`ModelBuilder` exactly as the
    reference's ``TrainSession`` composes it."""

    def __init__(self, num_latent: int = 16, burnin: int = 100,
                 nsamples: int = 100, seed: int = 0,
                 priors: Sequence[str] = ("normal", "normal"),
                 device: DeviceLike = None,
                 save_freq: int = 0, save_dir: Optional[str] = None,
                 callbacks: Sequence[Callable[[SweepInfo], None]] = ()):
        self.num_latent = num_latent
        self.burnin = burnin
        self.nsamples = nsamples
        self.seed = seed
        self.prior_names = tuple(p.replace("-", "").replace("_", "")
                                 for p in priors)
        self.device = resolve_device(device)
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.callbacks = callbacks
        self._train: Optional[SparseMatrix] = None
        self._test: Optional[TestSet] = None
        self._noise: Any = FixedGaussian(5.0)

    def add_train_and_test(self, train, test=None, noise=None):
        """train: SparseMatrix; test: (i, j, v)."""
        if not isinstance(train, SparseMatrix):
            raise _unsupported("dense training data")
        self._train = train
        if test is not None:
            self._test = make_test_set(*test, device=self.device)
        if noise is not None:
            self._noise = noise
        return self

    def add_side_info(self, axis: int, F: np.ndarray, **_):
        raise _unsupported("side information (the Macau prior)")

    def _builder(self) -> ModelBuilder:
        if self._train is None:
            raise ValueError("call add_train_and_test first")
        n_rows, n_cols = self._train.shape
        b = ModelBuilder(self.num_latent, self.device)
        for axis, (name, n) in enumerate((("rows", n_rows),
                                          ("cols", n_cols))):
            b.add_entity(name, n, prior=self.prior_names[axis])
        b.add_block("rows", "cols", self._train, noise=self._noise,
                    test=self._test)
        return b

    def run(self, keep_samples: bool = False) -> SessionResult:
        sess = self._builder().session(
            burnin=self.burnin, nsamples=self.nsamples, seed=self.seed,
            save_freq=self.save_freq, save_dir=self.save_dir,
            callbacks=self.callbacks)
        return sess.run(keep_samples=keep_samples)
