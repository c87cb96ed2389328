"""Dev script: run the Gaussian slice of several source trees in turns.

    python scripts_dev/slice_ab.py TREE [TREE ...]

Run from the repository root on a machine with one H100.  Each TREE is
the root of a checkout (``.`` for this one; another commit unpacked
with ``git archive <commit> | tar -x -C build/<dir>``); give them in
the order to run, e.g. ``build/parent . . build/parent``.  Each runs in
a fresh process: that tree's own ``chip_smoke.slice_data`` (131,072
compounds x 8,192 proteins, seed 0) and ``chip_smoke.phase_slice`` (4
burn-in sweeps and 2 samples at K = 128), which checks its launch
counts.  One JSON line per run: the tree, the rmse_train trace, the
test RMSE, each sweep's ms and the median after the first.  Then the
card's nvidia-smi name and power limit.
"""
import json
import subprocess
import sys

_CHILD = r"""
import json, os, statistics, sys
root = os.path.abspath(sys.argv[1])
os.chdir(root)
sys.path[:0] = [os.path.join(root, "src"), os.path.join(root, "scripts_dev"),
                root]
import chip_smoke as cs
from repro_torch.kernels import _build
_build.build_all(["gram", "sddmm"])
train, test = cs.slice_data(cs.COMPOUNDS, 0, "cuda")
_, res, _, ms = cs.phase_slice(train, test, *cs.SWEEPS, 0)
print("RESULT " + json.dumps({
    "trace": res.rmse_train_trace, "rmse_test": res.rmse_test, "ms": ms,
    "median_ms": statistics.median(ms[1:])}))
"""


def main(trees) -> int:
    if not trees:
        print(__doc__)
        return 2
    results = []
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", _CHILD, tree],
                             capture_output=True, text=True)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if out.returncode != 0 or not lines:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return 1
        r = {"tree": tree, **json.loads(lines[-1][len("RESULT "):])}
        results.append(r)
        print(json.dumps(r))
    by_tree = {}
    for r in results:
        by_tree.setdefault(r["tree"], []).append(r["median_ms"])
    traces = {json.dumps(r["trace"]) for r in results}
    print(json.dumps({"median_ms_by_tree": by_tree,
                      "same_trace_everywhere": len(traces) == 1}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
