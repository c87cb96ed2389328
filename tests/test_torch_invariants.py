"""The port's invariant linter, ``python -m repro_torch.analysis``.

* it runs clean on ``src/repro_torch`` (no suppression pragma there);
* each rule it carries over fires at the right line of an inline source
  string, scoped by a ``treat-as`` pragma, and stays quiet on the
  sanctioned form of the same code;
* the ``disable=`` pragma suppresses a finding, on its line or on the
  comment line above;
* the CLI's exit codes and rule catalogue; unknown rule ids name the
  valid ones, as the reference's do.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import invariants as ref_invariants
from repro_torch.analysis import RULES, lint_paths, lint_source, resolve_rules
from repro_torch.analysis import __main__ as cli
from torch_threads import _one_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _lint(src: str, treat_as: str):
    src = f"# repro-lint: treat-as={treat_as}\n" + textwrap.dedent(
        src).lstrip("\n")
    return [(f.rule, f.line) for f in lint_source(src, path="probe.py")]


def test_the_port_is_clean():
    assert lint_paths() == []
    assert lint_paths([PORT]) == []
    for path in PORT.rglob("*.py"):
        if path.parent.name != "analysis":   # the linter documents it
            assert "repro-lint:" not in path.read_text(), path


def test_rules_carried_over_from_the_reference():
    carried = {"batch-rng-in-sweep-path", "registry-error-without-choices",
               "nondeterminism-in-core", "timing-outside-obs",
               "checkpoint-load-in-serving-request-path"}
    assert set(RULES) == carried
    assert carried | {"experimental-import-outside-compat"} <= set(
        ref_invariants.RULES)
    for r in RULES.values():
        assert r.description and r.why


# (rule, module the source is treated as, source, lines that must fire);
# line 1 is the treat-as pragma
_FIRES = [
    ("batch-rng-in-sweep-path", "core/gibbs.py", """
        import torch
        from .. import random

        def _sample(key, n, k):
            z = torch.randn(n, k)
            u = random.uniform(key, (n, k))
            return z + u

        def row_normals(key, n, k):
            return random.normal(key, (n, k))
        """, [6, 7]),
    ("batch-rng-in-sweep-path", "core/noise.py", """
        from ..random import bernoulli as bern

        def augment(key, x):
            x.normal_()
            return bern(key, 0.5, x.shape)
        """, [5, 6]),
    ("registry-error-without-choices", "core/session.py", """
        _P = {"a": 1}

        def get(name):
            if name not in _P:
                raise ValueError(f"unknown {name!r}")
            return _P[name]

        def get_listed(name):
            if name not in _P:
                raise ValueError(f"unknown {name!r}; valid: "
                                 f"{', '.join(sorted(_P))}")
            return _P[name]
        """, [6]),
    ("nondeterminism-in-core", "core/session.py", """
        import time
        import numpy as np
        import torch

        def run(x, g):
            t0 = time.perf_counter()
            torch.manual_seed(0)
            a = torch.rand(3)
            b = torch.rand(3, generator=g)
            x.uniform_()
            c = np.random.normal(size=3)
            d = np.random.default_rng(4).normal(size=3)
            return t0, a, b, c, d
        """, [7, 8, 9, 11, 12]),
    ("checkpoint-load-in-serving-request-path", "launch/serve.py", """
        class Server:
            def __init__(self, p):
                self.cache = p.restore_latest()

            def warm(self, p):
                return p.load_sample(0)

            def step(self, p):
                return p.load_sample(1)
        """, [10]),
    ("timing-outside-obs", "kernels/_build.py", """
        import time
        from time import monotonic as mono

        def build():
            t0 = time.perf_counter()
            time.sleep(0)
            return mono() - t0
        """, [6, 8]),
]


@pytest.mark.parametrize("rule,treat_as,src,lines", _FIRES,
                         ids=[f"{r}-{t}" for r, t, _, _ in _FIRES])
def test_each_rule_fires_at_its_line(rule, treat_as, src, lines):
    found = _lint(src, treat_as)
    assert [ln for r, ln in found if r == rule] == lines, found


@pytest.mark.parametrize("rule,elsewhere", [
    ("batch-rng-in-sweep-path", "core/predict.py"),
    ("nondeterminism-in-core", "kernels/ops.py"),
    ("checkpoint-load-in-serving-request-path", "core/predict.py"),
    ("timing-outside-obs", "obs/recorder.py"),
])
def test_path_scoped_rules_stay_in_their_scope(rule, elsewhere):
    src = next(s for r, _, s, _ in _FIRES if r == rule)
    assert [r for r, _ in _lint(src, elsewhere) if r == rule] == []


def test_core_clock_reads_are_one_finding_not_two():
    found = _lint("""
        import time
        t = time.perf_counter()
        """, "core/gibbs.py")
    assert found == [("nondeterminism-in-core", 3)]


def test_pragma_suppresses_a_finding():
    src = """
        import time

        def build():
            a = time.perf_counter()  # repro-lint: disable=timing-outside-obs
            # repro-lint: disable=all
            b = time.monotonic()
            c = time.time()  # repro-lint: disable=nondeterminism-in-core
            return a, b, c
        """
    assert _lint(src, "kernels/_build.py") == [("timing-outside-obs", 8)]


def test_cli_exit_codes_and_output(tmp_path, capsys):
    assert cli.main([]) == 0
    bad = tmp_path / "bad.py"
    bad.write_text("# repro-lint: treat-as=launch/x.py\nimport time\n"
                   "t = time.time()\n")
    assert cli.main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert f"{bad}:3: [timing-outside-obs]" in out and "fix:" in out
    assert cli.main([str(bad), "--rules", "nondeterminism-in-core"]) == 0
    assert cli.main(["--list-rules"]) == 0
    assert "timing-outside-obs" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["--rules", "bogus"])
    assert "valid rules:" in capsys.readouterr().err


def test_unknown_rule_names_the_valid_ones():
    with pytest.raises(ValueError) as ei:
        resolve_rules("timing-outside-obs,bogus")
    assert "unknown rule(s) bogus; valid rules: " in str(ei.value)
    assert [r.id for r in resolve_rules("timing-outside-obs")] == [
        "timing-outside-obs"]


def test_module_entry_point_runs_clean():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert '"count": 0' in out.stdout
