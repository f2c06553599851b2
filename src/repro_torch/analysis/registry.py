"""Rule registry for the port's invariant linter.

A rule is a function ``check(project) -> Iterable[Finding]`` registered under
a stable ``REPxxx`` code via the :func:`rule` decorator.  Codes are the
public contract: suppressions (``# repro: disable=REPxxx``), CI output, and
docs/analysis_torch.md all key on them, so codes are never reused or
renumbered — a retired rule keeps its code as a tombstone.  The codes and the
``Finding`` shape are the JAX package's linter's, so one suppression syntax
and one report format serve both trees.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Iterable, Iterator, List

CODE_RE = re.compile(r"^REP\d{3}$")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a source location.

    ``path`` is repo-relative (posix separators) so output is stable across
    checkouts; ``line`` is 1-based.  ``suppressed`` is filled in by the
    driver after matching per-line directives — rules always emit findings
    unsuppressed and never look at comments themselves.
    """

    path: str
    line: int
    code: str
    message: str
    suppressed: bool = False

    def as_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "code": self.code,
                "message": self.message, "suppressed": self.suppressed}

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.code} {self.message}{tag}"


@dataclasses.dataclass(frozen=True)
class Rule:
    code: str
    name: str
    summary: str
    check: Callable[["object"], Iterable[Finding]]


_RULES: Dict[str, Rule] = {}


def rule(code: str, name: str, summary: str):
    """Register ``fn`` as the checker for ``code``."""
    if not CODE_RE.match(code):
        raise ValueError(f"rule code must match REPxxx: {code!r}")

    def deco(fn: Callable) -> Callable:
        if code in _RULES:
            raise ValueError(f"duplicate rule code {code}")
        _RULES[code] = Rule(code=code, name=name, summary=summary, check=fn)
        return fn

    return deco


def all_rules() -> List[Rule]:
    return [_RULES[c] for c in sorted(_RULES)]


def known_codes() -> frozenset:
    return frozenset(_RULES)


def run_rules(project, select: Iterable[str] | None = None) -> Iterator[Finding]:
    """Run every registered rule (or the ``select`` subset) over ``project``
    and yield raw findings in (path, line, code) order."""
    wanted = set(select) if select else None
    out: List[Finding] = []
    for r in all_rules():
        if wanted is not None and r.code not in wanted:
            continue
        out.extend(r.check(project))
    yield from sorted(out)
