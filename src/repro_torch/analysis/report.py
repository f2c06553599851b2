"""Rendering for linter results — text for humans, JSON for CI artifacts,
GitHub workflow-annotation lines for inline PR review."""
from __future__ import annotations

import json
from collections import Counter
from typing import List, Optional

from .registry import Finding


def split(findings: List[Finding]):
    active = [f for f in findings if not f.suppressed]
    muted = [f for f in findings if f.suppressed]
    return active, muted


def _summary_line(active, muted, files_scanned: int,
                  elapsed_s: Optional[float]) -> str:
    took = f" in {elapsed_s:.2f}s" if elapsed_s is not None else ""
    if active:
        counts = Counter(f.code for f in active)
        by_code = ", ".join(f"{c}:{n}" for c, n in sorted(counts.items()))
        return (f"{len(active)} finding(s) [{by_code}] "
                f"({len(muted)} suppressed) across "
                f"{files_scanned} files{took}")
    return (f"clean: 0 findings ({len(muted)} suppressed) "
            f"across {files_scanned} files{took}")


def render_text(findings: List[Finding], files_scanned: int,
                elapsed_s: Optional[float] = None) -> str:
    active, muted = split(findings)
    lines = [f.render() for f in findings]
    lines.append(_summary_line(active, muted, files_scanned, elapsed_s))
    return "\n".join(lines)


def render_json(findings: List[Finding], files_scanned: int,
                elapsed_s: Optional[float] = None) -> str:
    active, muted = split(findings)
    doc = {
        "version": 1,
        "files_scanned": files_scanned,
        "findings": [f.as_dict() for f in findings],
        "unsuppressed": len(active),
        "suppressed": len(muted),
        "counts": dict(sorted(Counter(f.code for f in active).items())),
        "ok": not active,
    }
    if elapsed_s is not None:
        doc["elapsed_s"] = round(elapsed_s, 3)
    return json.dumps(doc, indent=2, sort_keys=True)


def _gh_escape(value: str, *, prop: bool = False) -> str:
    """GitHub workflow-command escaping: data escapes %, CR, LF;
    property values additionally escape ':' and ','."""
    out = value.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A")
    if prop:
        out = out.replace(":", "%3A").replace(",", "%2C")
    return out


def render_github(findings: List[Finding], files_scanned: int,
                  elapsed_s: Optional[float] = None) -> str:
    """``::error file=...,line=...,title=REPxxx::message`` lines GitHub
    renders inline on the PR diff; suppressed findings become notices so
    the audit trail stays visible without failing the job."""
    active, muted = split(findings)
    lines = []
    for f in findings:
        level = "notice" if f.suppressed else "error"
        msg = f.message if not f.suppressed else f"[suppressed] {f.message}"
        lines.append(
            f"::{level} file={_gh_escape(f.path, prop=True)},"
            f"line={f.line},title={_gh_escape(f.code, prop=True)}"
            f"::{_gh_escape(msg)}")
    lines.append(_summary_line(active, muted, files_scanned, elapsed_s))
    return "\n".join(lines)
