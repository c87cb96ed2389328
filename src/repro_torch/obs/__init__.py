"""Observability of the port: spans, counters, fixed-bucket histograms,
Chrome-trace export and JSON/Prometheus metrics snapshots.

A copy of ``repro/obs`` (pure Python), kept in the port because the
port imports nothing of ``repro``.  The snapshot and trace formats are
the reference's, so the two packages' exports read alike.  The
checkpoint manager, the posterior cache and the serving layer record
into it; wiring sweep spans into ``Session`` is still to be ported
(ROADMAP A9).
"""
from . import clock  # noqa: F401  (the port's wall-clock module)
from .metrics import (Histogram, METRICS_FORMAT, TRACE_FORMAT,
                      integer_buckets, latency_buckets, percentile_summary,
                      prometheus_text, write_json_atomic)
from .recorder import Recorder, obs_enabled, resolve_recorder

__all__ = [
    "Histogram", "METRICS_FORMAT", "TRACE_FORMAT", "Recorder", "clock",
    "integer_buckets", "latency_buckets", "obs_enabled",
    "percentile_summary", "prometheus_text", "resolve_recorder",
    "write_json_atomic",
]
