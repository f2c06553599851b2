"""repro_torch.analysis — the port's AST-based invariant linter.

The port rests on the same disciplines as the JAX package, in their torch
form: serial<->batched<->campaign bit-parity of the cost path, the R-pinned
"run the exact pre-R cost program" rule, byte-identical host numpy draw
streams, thread-safe shared caches under the DSE service dispatcher, and no
host wait inside a GA generation.  This package encodes them as mechanical
AST rules (REP000–REP009, catalogued in docs/analysis_torch.md) over
``src/repro_torch``, with per-line suppressions and a CLI wired into the
tests (tests/test_torch_lint_clean.py).  It is stdlib ``ast`` only: it
parses the tree and never imports it, so it runs without torch.

Usage::

    python -m repro_torch.analysis                # text, exit 1 on findings
    python -m repro_torch.analysis --format json  # CI artifact
    repro-torch-lint --list-rules                 # rule catalogue

Suppression (justification mandatory; one syntax serves both trees)::

    thing()  # repro: disable=REP003 -- audited: single-threaded setup path
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence

from .registry import Finding, Rule, all_rules, run_rules
from .walker import Project
from . import rules as _rules  # noqa: F401  (importing registers REP rules)

__all__ = ["Finding", "Rule", "Project", "all_rules", "analyze",
           "find_root"]


def find_root(start: Optional[Path] = None) -> Path:
    """Nearest ancestor of ``start`` (default cwd) with a pyproject.toml —
    the repo root all scan paths and finding paths are relative to."""
    cur = (start or Path.cwd()).resolve()
    for cand in [cur, *cur.parents]:
        if (cand / "pyproject.toml").is_file():
            return cand
    return cur


def analyze(project: Project,
            select: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the rules and mark findings silenced by a same-line
    ``# repro: disable=REPxxx`` directive as suppressed."""
    out: List[Finding] = []
    for f in run_rules(project, select):
        sf = project.by_rel(f.path)
        d = sf.directives.get(f.line) if sf else None
        if d is not None and d.silences(f.code):
            f = dataclasses.replace(f, suppressed=True)
        out.append(f)
    return out
