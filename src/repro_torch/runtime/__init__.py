"""Fault tolerance, elastic restart, stragglers, and worlds of ranks.

The counterpart of ``repro/runtime``, plus ``world`` (one process a
rank, where the reference simulates devices in one process).
"""
from .fault import ElasticMesh, FailureSim, best_mesh_shape, run_with_restarts
from .straggler import StragglerMonitor
from .world import init_world, run_world

__all__ = ["ElasticMesh", "FailureSim", "best_mesh_shape",
           "run_with_restarts", "StragglerMonitor", "init_world",
           "run_world"]
