"""AST invariant linter for the port (``src/repro_torch``).

A port of ``repro/analysis/invariants.py``: the same rule registry, the
same ``file:line: [rule] message`` findings with a fix hint, the same
suppression pragma, with each rule restated for PyTorch.  The linter is
static: it parses source with :mod:`ast` and never imports the module
under inspection.

Rules carried over:

* ``batch-rng-in-sweep-path``: no batch-shaped draw on the sweep path
  (``core/{gibbs,priors,noise}.py``) outside the counter helpers, the
  init and the replicated hyper draws -- neither the threefry module's
  (``random.normal`` ...) nor PyTorch's (``torch.randn``,
  ``Tensor.normal_`` ...);
* ``registry-error-without-choices``: a ``x not in registry``
  ValueError names the valid choices;
* ``nondeterminism-in-core``: ``core/`` reads no clock, draws from no
  global numpy or torch generator and seeds none (``torch.manual_seed``);
* ``checkpoint-load-in-serving-request-path``: ``launch/serve.py``
  loads the sample store only at construction;
* ``timing-outside-obs``: wall-clock reads only in ``obs/``.

The reference's ``experimental-import-outside-compat`` is left out: it
keeps JAX's version-gated imports (``jax.experimental``, ``jax._src``)
in one module, and the port imports no JAX.

Suppression: append ``# repro-lint: disable=<rule-id>[,<rule-id>...]``
(or ``disable=all``) to the offending line, or put it on a comment-only
line directly above.  A source may carry ``# repro-lint:
treat-as=<relpath>`` in its first lines, so that path-scoped rules can
be tried on a source outside ``src/repro_torch``.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

# the port's package root (.../src/repro_torch); default lint target
PORT_ROOT = Path(__file__).resolve().parents[1]

_DISABLE_RE = re.compile(r"#\s*repro-lint:\s*disable=([\w,\-]+)")
_TREAT_AS_RE = re.compile(r"#\s*repro-lint:\s*treat-as=(\S+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str
    hint: str

    def format(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] "
                f"{self.message}\n    fix: {self.hint}")


@dataclasses.dataclass(frozen=True)
class LintRule:
    id: str
    description: str
    why: str
    check: Callable[["_Ctx"], Iterable[Finding]]


RULES: Dict[str, LintRule] = {}


def rule(rule_id: str, description: str, why: str):
    """Register a lint rule (decorator over ``check(ctx)``)."""
    def deco(fn):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        RULES[rule_id] = LintRule(rule_id, description, why, fn)
        return fn
    return deco


def resolve_rules(spec: Optional[str] = "all") -> List[LintRule]:
    """``'all'`` or a comma-separated id list -> rule objects."""
    if spec in (None, "", "all"):
        return list(RULES.values())
    ids = [s.strip() for s in spec.split(",") if s.strip()]
    unknown = [i for i in ids if i not in RULES]
    if unknown:
        raise ValueError(
            f"unknown rule(s) {', '.join(unknown)}; "
            f"valid rules: {', '.join(sorted(RULES))}")
    return [RULES[i] for i in ids]


class _Ctx:
    """Everything a rule needs about one file, parsed once."""

    def __init__(self, src: str, path: str, relpath: str):
        self.src = src
        self.path = path
        self.relpath = relpath
        self.tree = ast.parse(src)
        self.lines = src.splitlines()
        # nearest enclosing named function of every node
        self._enclosing: Dict[int, Optional[str]] = {}
        self._map_functions(self.tree, None)

    def _map_functions(self, node: ast.AST, fname: Optional[str]):
        self._enclosing[id(node)] = fname
        inner = fname
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inner = node.name
        for child in ast.iter_child_nodes(node):
            self._map_functions(child, inner)

    def enclosing_function(self, node: ast.AST) -> Optional[str]:
        return self._enclosing.get(id(node))

    def finding(self, node: ast.AST, rule_id: str, message: str,
                hint: str) -> Finding:
        return Finding(self.path, getattr(node, "lineno", 1),
                       rule_id, message, hint)


def _calls(ctx: _Ctx) -> Iterable[ast.Call]:
    return (n for n in ast.walk(ctx.tree) if isinstance(n, ast.Call))


# the draws of PyTorch's generators: module functions and in-place
# tensor methods
_TORCH_DRAWS = ("rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial", "poisson", "rand_like",
                "randn_like", "randint_like")
_TORCH_DRAW_RE = re.compile(
    r"(?:^|\.)torch\.(" + "|".join(_TORCH_DRAWS) + r")$")
_INPLACE_DRAWS = ("normal_", "uniform_", "bernoulli_", "random_",
                  "exponential_", "geometric_", "log_normal_", "cauchy_")


def _torch_draw(node: ast.Call) -> Optional[str]:
    """``torch.<draw>`` or ``<tensor>.<draw>_`` of a call, else None."""
    func_src = ast.unparse(node.func)
    m = _TORCH_DRAW_RE.search(func_src)
    if m:
        return f"torch.{m.group(1)}"
    if isinstance(node.func, ast.Attribute) and \
            node.func.attr in _INPLACE_DRAWS and \
            not func_src.startswith(("torch.", "random.")):
        return f"Tensor.{node.func.attr}"
    return None


# ---------------------------------------------------------------------------
# rule 1: counter-based RNG on the sweep path
# ---------------------------------------------------------------------------

_SWEEP_MODULES = {"core/gibbs.py", "core/priors.py", "core/noise.py"}
# batch-shaped draw kinds of the threefry module (``repro_torch.random``)
_BATCH_DRAWS = {"normal", "uniform", "bernoulli", "truncated_normal"}
# init, the counter-based helpers, and the replicated hyper draws
_RNG_WHITELIST = {
    "init_state",                   # pre-sweep init
    "row_normals", "row_uniforms", "row_bernoulli",  # counter-based
    "sample_mvn_from_precision",    # replicated hyper draw (K-sized)
    "sample_wishart",               # replicated hyper draw (K x K)
    "sample_hyper_moments",         # Macau beta draw, replicated
}
_RANDOM_CALL_RE = re.compile(
    r"(?:^|\.)random\.(normal|uniform|bernoulli|truncated_normal)$")


@rule(
    "batch-rng-in-sweep-path",
    "batch-shaped draws in sweep-path modules must go through the "
    "counter-based row_* helpers",
    "as in the reference: a batch-shaped bernoulli draw in the "
    "spike-and-slab update forked chains under sharding; a row's draws "
    "are the same bits on any shard only when every per-row draw folds "
    "the global row index into the key, and in the port a draw from "
    "torch's generators also leaves the reference's threefry stream",
)
def _check_batch_rng(ctx: _Ctx) -> Iterable[Finding]:
    if ctx.relpath not in _SWEEP_MODULES:
        return
    # names imported directly: from ..random import normal [as n]
    direct: Dict[str, str] = {}
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[-1] == "random":
            for a in node.names:
                if a.name in _BATCH_DRAWS:
                    direct[a.asname or a.name] = a.name
    for node in _calls(ctx):
        func_src = ast.unparse(node.func)
        m = _RANDOM_CALL_RE.search(func_src)
        draw = (f"random.{m.group(1)}" if m else
                f"random.{direct[func_src]}" if func_src in direct else
                _torch_draw(node))
        if draw is None:
            continue
        fname = ctx.enclosing_function(node)
        if fname in _RNG_WHITELIST:
            continue
        where = f"in {fname}()" if fname else "at module level"
        yield ctx.finding(
            node, "batch-rng-in-sweep-path",
            f"batch-shaped {draw} draw {where} on the sweep path",
            "use gibbs.row_normals/row_uniforms/row_bernoulli (they "
            "fold the global row index into the key) or, for genuine "
            "init/replicated-hyper code, add the function to the "
            "whitelist in repro_torch/analysis/invariants.py")


# ---------------------------------------------------------------------------
# rule 2: registry errors name the valid choices
# ---------------------------------------------------------------------------

@rule(
    "registry-error-without-choices",
    "a `x not in registry` ValueError must name the valid choices",
    "as in the reference: a typo'd name fails fast listing what would "
    "have worked (session._prior_by_name), and the port's errors carry "
    "the reference's messages",
)
def _check_registry_errors(ctx: _Ctx) -> Iterable[Finding]:
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.If)
                and isinstance(node.test, ast.Compare)
                and len(node.test.ops) == 1
                and isinstance(node.test.ops[0], ast.NotIn)):
            continue
        registry_src = ast.unparse(node.test.comparators[0])
        # the choices may be formatted on a helper line feeding the
        # message, so inspect the whole if-body, not just the raise
        body_src = "\n".join(ast.unparse(s) for s in node.body)
        if ".join(" in body_src or registry_src in body_src:
            continue
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if not (isinstance(sub, ast.Raise) and sub.exc
                        and isinstance(sub.exc, ast.Call)):
                    continue
                f = sub.exc.func
                exc_name = f.id if isinstance(f, ast.Name) else (
                    f.attr if isinstance(f, ast.Attribute) else "")
                if exc_name != "ValueError":
                    continue
                yield ctx.finding(
                    sub, "registry-error-without-choices",
                    f"ValueError after `not in {registry_src}` does "
                    "not name the valid choices",
                    "include the registry keys in the message, e.g. "
                    "f\"unknown x {name!r}; valid: "
                    "{', '.join(sorted(" + registry_src + "))}\"")


# ---------------------------------------------------------------------------
# rule 3: no wall-clock / global-RNG nondeterminism in core/
# ---------------------------------------------------------------------------

_CLOCK_CALL_RE = re.compile(
    r"(?:^|\.)time\.(?:time|time_ns|perf_counter|perf_counter_ns|"
    r"monotonic|monotonic_ns)$"
    r"|(?:^|\.)datetime\.(?:now|utcnow)$"
    r"|(?:^|\.)date\.today$")
_NP_RANDOM_RE = re.compile(r"(?:^|\.)(?:np|numpy)\.random\.(\w+)$")
_TORCH_SEED_RE = re.compile(
    r"(?:^|\.)torch\.(?:cuda\.)?(?:manual_seed|manual_seed_all|seed|"
    r"seed_all|set_rng_state)$")


@rule(
    "nondeterminism-in-core",
    "core/ must not read wall-clock time, draw from a global numpy or "
    "torch generator, or seed one",
    "as in the reference: a chain is a pure function of (model, data, "
    "seed), bitwise; in the port every draw comes from the threefry "
    "keys of repro_torch.random or an explicitly seeded generator, and "
    "clocks and process-global generator state make runs unrepeatable",
)
def _check_nondeterminism(ctx: _Ctx) -> Iterable[Finding]:
    if not ctx.relpath.startswith("core/"):
        return
    for node in _calls(ctx):
        func_src = ast.unparse(node.func)
        m = _NP_RANDOM_RE.search(func_src)
        if m:
            attr = m.group(1)
            if attr == "default_rng" and (node.args or node.keywords):
                continue  # an explicitly seeded generator is fine
            what = ("unseeded np.random.default_rng()"
                    if attr == "default_rng"
                    else f"global-state np.random.{attr}(...)")
            yield ctx.finding(
                node, "nondeterminism-in-core", what,
                "thread a seed explicitly: threefry keys "
                "(repro_torch.random) on device paths, "
                "np.random.default_rng(seed) on host paths")
        elif _TORCH_SEED_RE.search(func_src):
            yield ctx.finding(
                node, "nondeterminism-in-core",
                f"global torch generator seeded by {func_src}(...)",
                "seed nothing globally: draw from threefry keys "
                "(repro_torch.random) or pass an explicitly seeded "
                "torch.Generator as generator=")
        elif _torch_draw(node) is not None and not any(
                k.arg == "generator" for k in node.keywords):
            yield ctx.finding(
                node, "nondeterminism-in-core",
                f"{_torch_draw(node)}(...) draws from the global torch "
                "generator",
                "draw from threefry keys (repro_torch.random), or pass "
                "an explicitly seeded torch.Generator as generator=")
        elif _CLOCK_CALL_RE.search(func_src):
            yield ctx.finding(
                node, "nondeterminism-in-core",
                f"wall-clock read {func_src}(...)",
                "core/ results must be a pure function of (model, "
                "data, seed); record timing through a repro_torch.obs "
                "Recorder span or obs.clock (only ever reported, never "
                "fed back into a computation)")


# ---------------------------------------------------------------------------
# rule 4: serving request paths never touch the checkpoint loader
# ---------------------------------------------------------------------------

_SERVING_MODULES = ("launch/serve.py",)
_CKPT_LOADERS = {"load_pytree", "load_sample", "restore_latest",
                 "samples", "load_model_spec"}


@rule(
    "checkpoint-load-in-serving-request-path",
    "serving modules may load the sample store only at construction "
    "(__init__ / warm*-prefixed functions), never per request",
    "as in the reference: PredictSession re-read the whole sample "
    "store from disk on every predict call; the resident posterior "
    "cache fixed it, and this rule keeps a per-request reload out of "
    "the server",
)
def _check_serving_loads(ctx: _Ctx) -> Iterable[Finding]:
    if ctx.relpath not in _SERVING_MODULES:
        return
    for node in _calls(ctx):
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else "")
        if name not in _CKPT_LOADERS:
            continue
        fname = ctx.enclosing_function(node)
        if fname == "__init__" or (fname or "").startswith("warm"):
            continue
        where = f"in {fname}()" if fname else "at module level"
        yield ctx.finding(
            node, "checkpoint-load-in-serving-request-path",
            f"checkpoint load {name}(...) {where}, a serving request "
            "path",
            "load the store once at construction (warm_cache() in "
            "__init__) and serve every request from the resident "
            "PosteriorCache; lazy streaming belongs in core/predict, "
            "not the server")


# ---------------------------------------------------------------------------
# rule 5: wall-clock timing goes through repro_torch.obs
# ---------------------------------------------------------------------------

# the wall-clock readers obs.clock wraps; `time.sleep` is not a read
_WALL_CLOCK_FNS = ("time", "time_ns", "perf_counter", "perf_counter_ns",
                   "monotonic", "monotonic_ns", "process_time",
                   "process_time_ns", "thread_time", "thread_time_ns")
_TIME_ATTR_RE = re.compile(
    r"(?:^|\.)time\.(?:" + "|".join(_WALL_CLOCK_FNS) + r")$")


@rule(
    "timing-outside-obs",
    "wall-clock reads (time.perf_counter / time.monotonic / ...) "
    "outside repro_torch/obs: route timing through the obs package "
    "(Recorder spans, or obs.clock for bare durations)",
    "as in the reference: an inline perf_counter pair charged "
    "compilation to sweep time, and ad-hoc timers are how such "
    "regressions creep in; timing in one package is uniform, a no-op "
    "when disabled, and never fed back into a computation",
)
def _check_timing_outside_obs(ctx: _Ctx) -> Iterable[Finding]:
    # obs/ is the sanctioned home; core/ clock reads are findings of
    # the stricter nondeterminism-in-core rule (one finding a defect)
    if ctx.relpath.startswith(("obs/", "core/")):
        return
    hint = ("time a span with repro_torch.obs.Recorder "
            "(complete()/span()) so it lands in traces and metrics, or "
            "import the bare clock from repro_torch.obs "
            "(obs.clock.perf_counter / obs.clock.monotonic) for a plain "
            "duration")
    # direct-call aliases: `from time import perf_counter [as pc]`
    aliases = {}
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                if a.name in _WALL_CLOCK_FNS:
                    aliases[a.asname or a.name] = a.name
    for node in _calls(ctx):
        func_src = ast.unparse(node.func)
        if _TIME_ATTR_RE.search(func_src):
            yield ctx.finding(
                node, "timing-outside-obs",
                f"wall-clock read {func_src}(...) outside "
                "repro_torch/obs", hint)
        elif isinstance(node.func, ast.Name) and \
                node.func.id in aliases:
            yield ctx.finding(
                node, "timing-outside-obs",
                f"wall-clock read {node.func.id}(...) (from time "
                f"import {aliases[node.func.id]}) outside "
                "repro_torch/obs", hint)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def port_relpath(path: Path) -> str:
    """Path of a file relative to the port's package (posix), or its
    basename when outside the package (use ``treat-as`` there)."""
    try:
        return path.resolve().relative_to(PORT_ROOT).as_posix()
    except ValueError:
        return path.name


def _suppressions(lines: Sequence[str]) -> Dict[int, set]:
    out: Dict[int, set] = {}
    for i, line in enumerate(lines, start=1):
        m = _DISABLE_RE.search(line)
        if m:
            out[i] = {s.strip() for s in m.group(1).split(",")}
    return out


def _suppressed(finding: Finding, lines: Sequence[str],
                supp: Dict[int, set]) -> bool:
    def hit(ids):
        return ids is not None and \
            ("all" in ids or finding.rule in ids)
    if hit(supp.get(finding.line)):
        return True
    prev = finding.line - 1
    if prev >= 1 and prev <= len(lines) and \
            lines[prev - 1].lstrip().startswith("#"):
        return hit(supp.get(prev))
    return False


def lint_source(src: str, path: str = "<string>",
                rules: Optional[Sequence[LintRule]] = None
                ) -> List[Finding]:
    """Lint one source string; ``path`` is used for reporting and,
    unless a ``treat-as`` pragma overrides it, for rule scoping."""
    relpath = port_relpath(Path(path))
    for line in src.splitlines()[:10]:
        m = _TREAT_AS_RE.search(line)
        if m:
            relpath = m.group(1)
            break
    ctx = _Ctx(src, path, relpath)
    supp = _suppressions(ctx.lines)
    findings: List[Finding] = []
    for r in (rules if rules is not None else RULES.values()):
        findings.extend(f for f in r.check(ctx)
                        if not _suppressed(f, ctx.lines, supp))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def iter_py_files(paths: Sequence[Path]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(
                f for f in p.rglob("*.py")
                if "__pycache__" not in f.parts))
        else:
            out.append(p)
    return out


def lint_paths(paths: Optional[Sequence[Path]] = None,
               rules: Optional[Sequence[LintRule]] = None
               ) -> List[Finding]:
    """Lint files and directories (default: the whole port package)."""
    files = iter_py_files([PORT_ROOT] if paths is None else paths)
    findings: List[Finding] = []
    for f in files:
        findings.extend(lint_source(
            f.read_text(), path=str(f), rules=rules))
    return findings
