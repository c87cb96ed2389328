"""SMURFF core in PyTorch: the single-device Gibbs sweep and sessions.

Public API (the slice of ``repro.core`` ported so far):

    ModelBuilder, Session, TrainSession,
    GFASession, smurff, resolve_chains        -- compose and run chains
    PredictSession, PosteriorCache, RecResult -- serve a saved store
    NormalPrior, FixedNormalPrior, MacauPrior,
    SpikeAndSlabPrior                         -- priors
    FixedGaussian, AdaptiveGaussian,
    ProbitNoise                               -- noise models
    SparseMatrix, from_coo, from_dense,
    random_sparse, DenseBlock, dense_block    -- inputs
    ModelDef / MFData / MFState / gibbs_step  -- low-level engine
    chain_keys / multi_chain_step             -- several chains
    make_distributed_step, make_multi_chain_step,
    distributed_supported, resolve_pipeline   -- the distributed sweep
"""
from .blocks import BlockDef, DenseBlock, EntityDef, ModelDef, dense_block
from .distributed import (distributed_supported, make_distributed_step,
                          make_multi_chain_step, resolve_pipeline)
from .gibbs import (MFData, MFState, chain_keys, gibbs_step,
                    init_chain_states, init_state, multi_chain_step,
                    run_sweeps, stack_states, unstack_state,
                    with_side_grams)
from .noise import AdaptiveGaussian, FixedGaussian, ProbitNoise
from .predict import (PosteriorCache, PredictAccumulator, PredictSession,
                      RecResult, TestSet, make_test_set, predict_one, rmse)
from .priors import (FixedNormalPrior, MacauPrior, NormalPrior,
                     SpikeAndSlabPrior)
from .session import (BlockResult, GFASession, ModelBuilder, Session,
                      SessionResult, SweepInfo, TrainSession, resolve_chains,
                      smurff)
from .sparse import (PaddedRows, SparseMatrix, from_coo, from_dense,
                     random_sparse)

__all__ = [
    "BlockDef", "DenseBlock", "EntityDef", "ModelDef", "dense_block",
    "distributed_supported", "make_distributed_step",
    "make_multi_chain_step", "resolve_pipeline",
    "MFData", "MFState", "chain_keys", "gibbs_step", "init_chain_states",
    "init_state", "multi_chain_step", "run_sweeps", "stack_states",
    "unstack_state", "with_side_grams",
    "AdaptiveGaussian", "FixedGaussian", "ProbitNoise",
    "PosteriorCache", "PredictAccumulator", "PredictSession", "RecResult",
    "TestSet", "make_test_set", "predict_one", "rmse",
    "FixedNormalPrior", "MacauPrior", "NormalPrior", "SpikeAndSlabPrior",
    "BlockResult", "GFASession", "ModelBuilder", "Session",
    "SessionResult", "SweepInfo", "TrainSession", "resolve_chains",
    "smurff",
    "PaddedRows", "SparseMatrix", "from_coo", "from_dense",
    "random_sparse",
]
