"""Per-line suppression directives.

Syntax (must sit on the same physical line as the finding)::

    risky_call()  # repro: disable=REP003 -- audited: guarded by GIL here
    other()       # repro: disable=REP001,REP004 -- fixture exercises both

The ``--`` justification is mandatory: a directive without one is itself a
finding (REP000 in rules.py), so every suppression in the tree documents the
audit that allowed it.  Codes are comma-separated ``REPxxx`` tokens; unknown
codes are also REP000 findings (they silence nothing and usually mean a
typo'd suppression that somebody believes is active).
"""
from __future__ import annotations

import dataclasses
import io
import re
import tokenize
from typing import Dict, Tuple

# the comment may trail arbitrary code; nothing but whitespace and the
# justification may follow the directive itself
DIRECTIVE_RE = re.compile(
    r"#\s*repro:\s*disable=(?P<codes>[A-Za-z0-9_,\s]+?)"
    r"(?:\s+--\s*(?P<why>\S.*?))?\s*$")


@dataclasses.dataclass(frozen=True)
class Directive:
    line: int
    codes: Tuple[str, ...]
    justification: str | None

    def silences(self, code: str) -> bool:
        return code in self.codes


def scan(text: str) -> Dict[int, Directive]:
    """Map 1-based line number -> Directive for every suppression in
    ``text``.  Only real COMMENT tokens count — a directive quoted inside a
    string literal (docs, rule messages, test fixtures-as-strings) is inert.
    Lines without a directive are absent from the map."""
    out: Dict[int, Directive] = {}
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT or "repro:" not in tok.string:
            continue
        m = DIRECTIVE_RE.search(tok.string)
        if not m:
            continue
        i = tok.start[0]
        codes = tuple(c.strip() for c in m.group("codes").split(",")
                      if c.strip())
        out[i] = Directive(line=i, codes=codes,
                           justification=m.group("why"))
    return out
