"""Schema audit for observability exports (trace and metrics JSON).

The counterpart of ``repro/analysis/obsschema.py``: the port's recorder
(``repro_torch.obs``) writes the reference's formats,
``repro-obs-trace-v1`` and ``repro-obs-metrics-v1``, and this audit
holds an export to their structure, so that a recorder change that
drifts the schema (a renamed span, a dropped ``bytes_on_wire``
annotation, non-monotone histogram buckets) is found before a Perfetto
load or a dashboard breaks.  It reads the reference's samples under
``results/obs`` as well as the port's own exports.

Values are not pinned: wall-clock numbers differ per run by nature;
only structure, formats, and the invariants that make the files
consumable are.  Each finding names what to re-export.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import List

from ..obs import METRICS_FORMAT, TRACE_FORMAT

_EVENT_PHASES = {"X", "i", "C"}
_SWEEP_PHASES = {"burnin", "sample"}
_REGEN = ("re-export it with `Recorder.write_trace` / `write_metrics` "
          "of repro_torch.obs")


def _num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) \
        and math.isfinite(x)


def _trace_findings(p: Path, doc: dict) -> List[str]:
    out: List[str] = []
    meta = doc.get("repro")
    if not isinstance(meta, dict) or meta.get("format") != TRACE_FORMAT:
        out.append(f"{p}: missing/unknown repro.format (expected "
                   f"{TRACE_FORMAT!r}) — {_REGEN}")
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        out.append(f"{p}: traceEvents must be a non-empty list — "
                   f"{_REGEN}")
        return out
    sweep_spans = 0
    compile_spans = 0
    for i, ev in enumerate(events):
        where = f"{p}: traceEvents[{i}]"
        if not isinstance(ev, dict):
            out.append(f"{where}: event is not an object")
            continue
        name = ev.get("name")
        if not isinstance(name, str) or not name:
            out.append(f"{where}: missing event name")
            continue
        ph = ev.get("ph")
        if ph not in _EVENT_PHASES:
            out.append(f"{where} ({name}): ph {ph!r} not one of "
                       f"{sorted(_EVENT_PHASES)}")
        if not _num(ev.get("ts")) or ev["ts"] < 0:
            out.append(f"{where} ({name}): ts must be a finite "
                       "number >= 0 (µs from the trace epoch)")
        if ph == "X" and (not _num(ev.get("dur")) or ev["dur"] < 0):
            out.append(f"{where} ({name}): complete event needs "
                       "dur >= 0 µs")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                out.append(f"{where} ({name}): {k} must be an int")
        if name == "session/compile":
            compile_spans += 1
        if name == "sweep":
            sweep_spans += 1
            args = ev.get("args")
            if not isinstance(args, dict):
                out.append(f"{where}: sweep span has no args")
                continue
            bow = args.get("bytes_on_wire")
            if not isinstance(bow, int) or bow < 0:
                out.append(
                    f"{where}: sweep span args.bytes_on_wire must be "
                    "a contract-derived int >= 0 (see "
                    "analysis.contract.contract_wire_bytes)")
            if args.get("phase") not in _SWEEP_PHASES:
                out.append(f"{where}: sweep span args.phase "
                           f"{args.get('phase')!r} not in "
                           f"{sorted(_SWEEP_PHASES)}")
            if not isinstance(args.get("sweep"), int):
                out.append(f"{where}: sweep span args.sweep must be "
                           "the int sweep index")
    if isinstance(meta, dict) and meta.get("kind") == "session":
        if sweep_spans == 0:
            out.append(f"{p}: a session trace must carry at least one "
                       f"'sweep' span — {_REGEN}")
        if compile_spans == 0:
            out.append(f"{p}: a session trace must carry the "
                       f"'session/compile' span (the compile_s / "
                       f"runtime_s split) — {_REGEN}")
    return out


def _metrics_findings(p: Path, doc: dict) -> List[str]:
    out: List[str] = []
    for section in ("counters", "gauges", "histograms"):
        if not isinstance(doc.get(section), dict):
            out.append(f"{p}: missing {section} object — {_REGEN}")
            return out
    for name, v in doc["counters"].items():
        if not _num(v) or v < 0:
            out.append(f"{p}: counter {name!r} must be a finite "
                       "number >= 0")
    for name, v in doc["gauges"].items():
        if not _num(v):
            out.append(f"{p}: gauge {name!r} must be a finite number")
    for name, h in doc["histograms"].items():
        where = f"{p}: histogram {name!r}"
        if not isinstance(h, dict):
            out.append(f"{where}: not an object")
            continue
        bounds = h.get("bounds")
        counts = h.get("counts")
        if not isinstance(bounds, list) or not bounds or \
                not all(_num(b) for b in bounds) or \
                any(y <= x for x, y in zip(bounds, bounds[1:])):
            out.append(f"{where}: bounds must be a non-empty strictly "
                       "increasing list of finite numbers")
            continue
        if not isinstance(counts, list) or \
                len(counts) != len(bounds) + 1 or \
                not all(isinstance(c, int) and c >= 0 for c in counts):
            out.append(f"{where}: counts must be {len(bounds) + 1} "
                       "ints >= 0 (one per le-bound + overflow)")
            continue
        if h.get("total") != sum(counts):
            out.append(f"{where}: total {h.get('total')!r} != "
                       f"sum(counts) = {sum(counts)}")
        if not _num(h.get("sum")):
            out.append(f"{where}: sum must be a finite number")
    if doc.get("kind") == "serve":
        hists = set(doc["histograms"])
        for required in ("serve.queue_wait_s", "serve.execute_s",
                         "serve.batch_occupancy"):
            if required not in hists:
                out.append(
                    f"{p}: a serve metrics snapshot must carry the "
                    f"{required!r} histogram (the queue-wait/execute/"
                    f"occupancy split RecommendServer.metrics_snapshot "
                    f"exposes) — {_REGEN}")
    return out


def obs_schema_findings(json_path) -> List[str]:
    """Audit one committed obs sample (trace or metrics snapshot,
    detected by content).  Returns human-readable findings; empty
    means the file is a well-formed ``repro.obs`` export."""
    p = Path(json_path)
    try:
        doc = json.loads(p.read_text())
    except (OSError, json.JSONDecodeError) as e:
        return [f"{p}: unreadable JSON ({e})"]
    if not isinstance(doc, dict):
        return [f"{p}: expected a JSON object, got "
                f"{type(doc).__name__}"]
    if "traceEvents" in doc:
        return _trace_findings(p, doc)
    if doc.get("format") == METRICS_FORMAT:
        return _metrics_findings(p, doc)
    return [f"{p}: neither a Chrome trace (traceEvents) nor a "
            f"{METRICS_FORMAT!r} metrics snapshot — {_REGEN}"]
