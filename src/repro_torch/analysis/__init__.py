"""Static analysis of the port: the invariant linter.

``python -m repro_torch.analysis`` runs :mod:`.invariants`, a port of
the reference's AST linter with the rules that mean something for
PyTorch (counter-based draws on the sweep path, no nondeterminism in
``core/``, choice-naming registry errors, no store loads per serving
request, timing only in ``obs/``).
"""
from .invariants import (RULES, Finding, LintRule,  # noqa: F401
                         lint_paths, lint_source, resolve_rules)
