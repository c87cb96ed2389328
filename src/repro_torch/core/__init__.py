"""SMURFF core in PyTorch: the single-device Gaussian BMF sweep.

Public API (the slice of ``repro.core`` ported so far):

    ModelBuilder, Session, TrainSession       -- compose and run a chain
    PredictSession, PosteriorCache, RecResult -- serve a saved store
    NormalPrior                               -- prior
    FixedGaussian, AdaptiveGaussian           -- noise models
    SparseMatrix, from_coo, random_sparse     -- inputs
    ModelDef / MFData / MFState / gibbs_step  -- low-level engine
"""
from .blocks import BlockDef, EntityDef, ModelDef
from .gibbs import MFData, MFState, gibbs_step, init_state, run_sweeps
from .noise import AdaptiveGaussian, FixedGaussian
from .predict import (PosteriorCache, PredictAccumulator, PredictSession,
                      RecResult, TestSet, make_test_set, predict_one, rmse)
from .priors import NormalPrior
from .session import (BlockResult, ModelBuilder, Session, SessionResult,
                      SweepInfo, TrainSession)
from .sparse import PaddedRows, SparseMatrix, from_coo, random_sparse

__all__ = [
    "BlockDef", "EntityDef", "ModelDef",
    "MFData", "MFState", "gibbs_step", "init_state", "run_sweeps",
    "AdaptiveGaussian", "FixedGaussian",
    "PosteriorCache", "PredictAccumulator", "PredictSession", "RecResult",
    "TestSet", "make_test_set", "predict_one", "rmse", "NormalPrior",
    "BlockResult", "ModelBuilder", "Session", "SessionResult",
    "SweepInfo", "TrainSession",
    "PaddedRows", "SparseMatrix", "from_coo", "random_sparse",
]
