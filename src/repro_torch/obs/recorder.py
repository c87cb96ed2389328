"""The Recorder: spans, counters, gauges, histograms, trace export.

A copy of ``repro/obs/recorder.py``.  Determinism contract:

- A disabled Recorder never reads the clock.  Every public method
  checks ``self.enabled`` before anything else, so ``REPRO_OBS``
  unset costs one attribute load + branch per call site.
- Wall-clock values are only ever *recorded*, never fed back into a
  computation; a span that times work on the card ends after the
  caller's ``torch.cuda.synchronize()``.  Together these keep sampled
  chains the same bits with the recorder on or off.
- All mutation happens under one lock: the checkpoint manager's
  background save thread and the serving loop write into the same
  Recorder concurrently.

Span timestamps are relative to the Recorder's construction (its
trace epoch), exported in Chrome trace-event microseconds.
"""
from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence

from . import clock
from .metrics import (Histogram, METRICS_FORMAT, TRACE_FORMAT,
                      latency_buckets, prometheus_text, write_json_atomic)


def obs_enabled() -> bool:
    """True when the ``REPRO_OBS`` env var opts into observability."""
    return os.environ.get("REPRO_OBS", "").strip().lower() in (
        "1", "true", "yes", "on")


class Recorder:
    """Collects trace spans + metrics for one run/server.

    Construct with ``enabled=False`` (or via ``resolve_recorder(None)``
    with ``REPRO_OBS`` unset) for a no-op recorder: no clock reads, no
    allocations beyond the instance itself.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        self._tids: Dict[int, int] = {}
        self._epoch = clock.perf_counter() if self.enabled else 0.0
        self._kind: Optional[str] = None

    # -- internals ---------------------------------------------------

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = len(self._tids)
            self._tids[ident] = tid
        return tid

    def _push(self, event: dict) -> None:
        with self._lock:
            event["tid"] = self._tid()
            self._events.append(event)

    # -- spans -------------------------------------------------------

    def now(self) -> float:
        """Span start timestamp; 0.0 when disabled (never read then)."""
        return clock.perf_counter() if self.enabled else 0.0

    def complete(self, name: str, start: float, end: Optional[float] = None,
                 cat: str = "obs", **args: Any) -> None:
        """Record a complete ('X') span from an explicit start time.

        ``start``/``end`` are ``clock.perf_counter()`` readings — pass
        ``end`` explicitly when the span must stop at a fence (e.g.
        right after ``block_until_ready``) rather than at call time.
        """
        if not self.enabled:
            return
        if end is None:
            end = clock.perf_counter()
        self._push({"name": name, "cat": cat, "ph": "X",
                    "ts": (start - self._epoch) * 1e6,
                    "dur": max(end - start, 0.0) * 1e6,
                    "pid": 0, "args": args})

    @contextmanager
    def span(self, name: str, cat: str = "obs", **args: Any):
        """Context-manager span for non-hot paths (cache warm, restore)."""
        if not self.enabled:
            yield
            return
        t0 = clock.perf_counter()
        try:
            yield
        finally:
            self.complete(name, t0, cat=cat, **args)

    def instant(self, name: str, cat: str = "obs", **args: Any) -> None:
        if not self.enabled:
            return
        self._push({"name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": (clock.perf_counter() - self._epoch) * 1e6,
                    "pid": 0, "args": args})

    # -- metrics -----------------------------------------------------

    def add(self, name: str, n: float = 1.0) -> None:
        """Increment a monotonically-increasing counter."""
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + n

    def gauge(self, name: str, value: float) -> None:
        """Set a point-in-time gauge (queue depth, resident bytes)."""
        if not self.enabled:
            return
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float,
                bounds: Optional[Sequence[float]] = None) -> None:
        """Observe into the fixed-bucket histogram ``name``, creating
        it with ``bounds`` (default: latency buckets) on first use.
        Later ``bounds`` arguments are ignored — buckets are fixed."""
        if not self.enabled:
            return
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = Histogram(latency_buckets() if bounds is None else bounds)
                self._hists[name] = h
            h.observe(value)

    def histogram(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(name)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def reset(self) -> None:
        """Drop all recorded data (e.g. after a benchmark warm-up) and
        restart the trace epoch. Bucket layouts are not preserved."""
        with self._lock:
            self._events.clear()
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            if self.enabled:
                self._epoch = clock.perf_counter()

    def set_kind(self, kind: str) -> None:
        """Label the producing layer ('session', 'serve', …); stamped
        into exports so the schema audit can apply per-kind checks."""
        self._kind = kind

    # -- export ------------------------------------------------------

    def trace(self) -> dict:
        """Chrome trace-event JSON object (load in chrome://tracing or
        https://ui.perfetto.dev)."""
        with self._lock:
            events = [dict(e) for e in self._events]
        out = {"traceEvents": events, "displayTimeUnit": "ms",
               "repro": {"format": TRACE_FORMAT}}
        if self._kind:
            out["repro"]["kind"] = self._kind
        return out

    def metrics(self) -> dict:
        """JSON metrics snapshot: counters, gauges, histograms."""
        with self._lock:
            out = {"format": METRICS_FORMAT,
                   "counters": dict(self._counters),
                   "gauges": dict(self._gauges),
                   "histograms": {k: h.to_dict()
                                  for k, h in self._hists.items()}}
        if self._kind:
            out["kind"] = self._kind
        return out

    def prometheus(self) -> str:
        """The same snapshot in Prometheus text exposition format."""
        with self._lock:
            return prometheus_text(dict(self._counters), dict(self._gauges),
                                   dict(self._hists))

    def write_trace(self, path: str) -> None:
        write_json_atomic(path, self.trace())

    def write_metrics(self, path: str) -> None:
        write_json_atomic(path, self.metrics())


def resolve_recorder(recorder: Optional[Recorder]) -> Recorder:
    """Standard constructor-argument plumbing: an explicit Recorder
    wins; otherwise a fresh one, enabled iff ``REPRO_OBS`` is set.

    Fresh (not a global singleton) so two runs in one process never
    interleave their traces; layers that must share a recorder
    (session → its checkpoint savers) pass it down explicitly.
    """
    if recorder is not None:
        return recorder
    return Recorder(enabled=obs_enabled())
