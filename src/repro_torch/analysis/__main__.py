"""CLI of the port's invariant linter.

Usage::

    python -m repro_torch.analysis                  # lint src/repro_torch
    python -m repro_torch.analysis path1.py dir2/   # lint given paths
    python -m repro_torch.analysis --rules timing-outside-obs
    python -m repro_torch.analysis --json           # machine-readable
    python -m repro_torch.analysis --list-rules
    python -m repro_torch.analysis --obs DIR        # schema-audit the
                                                    # obs JSONs in DIR

The exit status is 0 with no findings and 1 otherwise.  ``--obs`` is
the reference's schema audit of trace and metrics exports
(``obsschema``); given alone it skips the lint pass.  The reference's
other passes (``--contracts``, ``--kernels``) audit the XLA program
and the Pallas kernels, and have no counterpart here.
"""
from __future__ import annotations

import argparse
import json as _json
import sys
from pathlib import Path

from . import invariants
from .obsschema import obs_schema_findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Invariant linter for the PyTorch port.")
    ap.add_argument(
        "paths", nargs="*", type=Path,
        help="files/directories to lint (default: the whole "
             "repro_torch package)")
    ap.add_argument(
        "--rules", default="all",
        help="comma-separated rule ids, or 'all' (default)")
    ap.add_argument(
        "--obs", metavar="DIR", type=Path, default=None,
        help="schema-audit the repro_torch.obs trace/metrics JSONs in "
             "DIR (given alone, skips the lint pass)")
    ap.add_argument(
        "--json", action="store_true",
        help="emit findings as one JSON object on stdout "
             "({findings: [{path, line, rule, message, hint}], "
             "count}) instead of text lines")
    ap.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in invariants.RULES.values():
            print(f"{r.id}\n    {r.description}\n    why: {r.why}\n")
        return 0

    try:
        rules = invariants.resolve_rules(args.rules)
    except ValueError as e:
        ap.error(str(e))

    findings = []
    if args.paths or args.obs is None:
        findings = invariants.lint_paths(args.paths or None, rules)
    obs_msgs = []           # plain strings from the obs schema audit
    if args.obs is not None:
        jsons = sorted(args.obs.glob("*.json"))
        if not jsons:
            print(f"{args.obs}: no obs JSONs to audit", file=sys.stderr)
        obs_msgs = [(j, msg) for j in jsons
                    for msg in obs_schema_findings(j)]
    n = len(findings) + len(obs_msgs)
    if args.json:
        recs = [{"path": f.path, "line": f.line, "rule": f.rule,
                 "message": f.message, "hint": f.hint}
                for f in findings]
        recs += [{"path": str(j), "line": 0, "rule": "obs-schema",
                  "message": msg,
                  "hint": "re-export with repro_torch.obs.Recorder"}
                 for j, msg in obs_msgs]
        print(_json.dumps({"findings": recs, "count": n}, indent=1))
    else:
        for f in findings:
            print(f.format())
        for _, msg in obs_msgs:
            print(msg)
    print(f"repro_torch.analysis: {n} finding(s)", file=sys.stderr)
    return 1 if n else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:     # e.g. `... --list-rules | head`
        sys.exit(0)
