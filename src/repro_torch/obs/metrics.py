"""Fixed-bucket histograms and metrics-snapshot formats.

A copy of ``repro/obs/metrics.py``.  Histograms here are the *shared*
latency primitive: the serving layer (``launch/serve.py``) and the
checkpoint manager observe into the same fixed-bucket structure, and
percentiles come out of one :meth:`Histogram.percentile`
implementation instead of N hand-rolled ``np.sort`` variants.

Buckets are fixed at construction (Prometheus-style `le` bounds), so
merging, serializing, and diffing snapshots across runs is exact:
two snapshots of the same metric always share bucket edges.
"""
from __future__ import annotations

import json
import math
import os
import re
import tempfile
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence

# Format tags stamped into every snapshot: the reference's, so that
# snapshots of the two packages share one schema.
METRICS_FORMAT = "repro-obs-metrics-v1"
TRACE_FORMAT = "repro-obs-trace-v1"


def latency_buckets(lo: float = 1e-4, hi: float = 120.0,
                    ratio: float = 1.25) -> List[float]:
    """Geometric latency bounds in seconds: 100 µs … 120 s.

    ratio=1.25 keeps worst-case interpolation error well under the
    run-to-run noise of any wall-clock measurement while staying at
    ~63 buckets per histogram — small enough to commit snapshots.
    """
    bounds = [lo]
    while bounds[-1] < hi:
        bounds.append(bounds[-1] * ratio)
    return bounds


def integer_buckets(n: int) -> List[float]:
    """Bounds that give every integer in [0, n] its own bucket.

    Used for batch occupancy: ``bisect(bounds, k)`` lands value ``k``
    in bucket ``k`` exactly, so the histogram is a lossless count per
    occupancy level and ``mean()`` is exact.
    """
    return [i + 0.5 for i in range(n + 1)]


class Histogram:
    """Fixed-bucket histogram with linear-interpolated percentiles.

    ``counts`` has ``len(bounds) + 1`` entries: one per ``le`` bound
    plus a final overflow bucket. ``sum``/``total`` make the snapshot
    a valid Prometheus histogram (``_sum`` / ``_count``).
    """

    __slots__ = ("bounds", "counts", "total", "sum")

    def __init__(self, bounds: Sequence[float]):
        b = [float(x) for x in bounds]
        if not b or any(y <= x for x, y in zip(b, b[1:])):
            raise ValueError("histogram bounds must be non-empty and "
                             "strictly increasing, got %r" % (bounds,))
        self.bounds: List[float] = b
        self.counts: List[int] = [0] * (len(b) + 1)
        self.total: int = 0
        self.sum: float = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect_left(self.bounds, v)] += 1
        self.total += 1
        self.sum += v

    def mean(self) -> float:
        return self.sum / self.total if self.total else math.nan

    def percentile(self, q: float) -> float:
        """Estimate the q-quantile (q in [0, 1]) by linear
        interpolation inside the bucket holding the target rank.

        The overflow bucket cannot be interpolated; it reports its
        lower edge (the largest finite bound) — a deliberate
        underestimate that keeps the value finite.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1], got %r" % (q,))
        if self.total == 0:
            return math.nan
        target = q * self.total
        cum = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                if i >= len(self.bounds):  # overflow bucket
                    return self.bounds[-1]
                hi = self.bounds[i]
                frac = (target - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.bounds[-1]

    def to_dict(self) -> dict:
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "total": self.total, "sum": self.sum}

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls(d["bounds"])
        counts = [int(c) for c in d["counts"]]
        if len(counts) != len(h.counts):
            raise ValueError("counts length %d does not match bounds "
                             "(%d + overflow)" % (len(counts), len(h.bounds)))
        h.counts = counts
        h.total = int(d["total"])
        h.sum = float(d["sum"])
        return h


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return "repro_" + _PROM_BAD.sub("_", name)


def prometheus_text(counters: Dict[str, float], gauges: Dict[str, float],
                    histograms: Dict[str, Histogram]) -> str:
    """Render a snapshot in the Prometheus text exposition format."""
    lines: List[str] = []
    for name in sorted(counters):
        p = _prom_name(name)
        lines.append("# TYPE %s counter" % p)
        lines.append("%s %g" % (p, counters[name]))
    for name in sorted(gauges):
        p = _prom_name(name)
        lines.append("# TYPE %s gauge" % p)
        lines.append("%s %g" % (p, gauges[name]))
    for name in sorted(histograms):
        h = histograms[name]
        p = _prom_name(name)
        lines.append("# TYPE %s histogram" % p)
        cum = 0
        for bound, count in zip(h.bounds, h.counts):
            cum += count
            lines.append('%s_bucket{le="%g"} %d' % (p, bound, cum))
        lines.append('%s_bucket{le="+Inf"} %d' % (p, h.total))
        lines.append("%s_sum %g" % (p, h.sum))
        lines.append("%s_count %d" % (p, h.total))
    return "\n".join(lines) + "\n"


def write_json_atomic(path: str, payload: dict) -> None:
    """Write JSON via a same-directory temp file + ``os.replace`` so a
    crashed exporter never leaves a half-written snapshot."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def percentile_summary(h: Optional[Histogram]) -> dict:
    """Small JSON-able digest of a histogram (used by benchmark and
    serving reports where the full bucket vector would be noise)."""
    if h is None or h.total == 0:
        return {"p50": None, "p99": None, "mean": None, "count": 0}
    return {"p50": h.percentile(0.50), "p99": h.percentile(0.99),
            "mean": h.mean(), "count": h.total}
