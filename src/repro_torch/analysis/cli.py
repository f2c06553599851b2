"""``python -m repro_torch.analysis`` / ``repro-torch-lint`` — run the rules.

Exit codes: 0 clean (suppressed findings allowed), 1 unsuppressed findings
or blown ``--budget-seconds``, 2 usage error (argparse).  CI runs
``--format github`` so findings render inline on the PR diff, keeps a
``--format json`` artifact, and passes ``--budget-seconds`` so the
interprocedural pass can't silently balloon job time.

``--baseline FILE`` supports incremental adoption: findings recorded in the
baseline (matched by path+code+message, line-insensitive so unrelated edits
don't churn it) are demoted to suppressed; only NEW findings fail the run.
``--write-baseline FILE`` snapshots the current unsuppressed findings.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from collections import Counter
from pathlib import Path
from typing import List

from . import analyze, find_root
from .registry import Finding, all_rules
from .report import render_github, render_json, render_text, split
from .walker import Project

_RENDERERS = {"text": render_text, "json": render_json,
              "github": render_github}

BASELINE_VERSION = 1


def _baseline_key(f: Finding) -> tuple:
    return (f.path, f.code, f.message)


def write_baseline(path: Path, findings: List[Finding]) -> None:
    active, _ = split(findings)
    doc = {"version": BASELINE_VERSION,
           "entries": [{"path": f.path, "code": f.code,
                        "message": f.message} for f in active]}
    path.write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")


def apply_baseline(path: Path, findings: List[Finding]) -> List[Finding]:
    """Demote baseline-matched findings to suppressed.  Matching is a
    multiset consume on (path, code, message): two identical findings in
    one file need two baseline entries, so fixing one of them surfaces."""
    doc = json.loads(path.read_text())
    budget = Counter((e["path"], e["code"], e["message"])
                     for e in doc.get("entries", ()))
    out: List[Finding] = []
    for f in findings:
        key = _baseline_key(f)
        if not f.suppressed and budget.get(key, 0) > 0:
            budget[key] -= 1
            f = dataclasses.replace(f, suppressed=True)
        out.append(f)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch-lint", description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to scan, relative to the repo root "
                         "(default: src/repro_torch)")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root (default: walk up from cwd to "
                         "pyproject.toml)")
    ap.add_argument("--format", choices=("text", "json", "github"),
                    default="text")
    ap.add_argument("--select", default=None, metavar="REPxxx[,REPxxx...]",
                    help="run only these rule codes")
    ap.add_argument("--baseline", type=Path, default=None, metavar="FILE",
                    help="demote findings recorded in FILE to suppressed "
                         "(incremental adoption; only NEW findings fail)")
    ap.add_argument("--write-baseline", type=Path, default=None,
                    metavar="FILE",
                    help="write the current unsuppressed findings to FILE "
                         "and exit 0")
    ap.add_argument("--budget-seconds", type=float, default=None,
                    metavar="S",
                    help="fail (exit 1) if the lint pass takes longer than "
                         "S seconds of wall clock")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in all_rules():
            print(f"{r.code} {r.name}: {r.summary}")
        return 0

    root = (args.root or find_root()).resolve()
    select = ([c.strip() for c in args.select.split(",") if c.strip()]
              if args.select else None)
    t0 = time.monotonic()
    project = Project.load(root, args.paths or None)
    findings = analyze(project, select=select)
    if args.write_baseline is not None:
        write_baseline(args.write_baseline, findings)
        active, _ = split(findings)
        print(f"baseline: {len(active)} finding(s) written to "
              f"{args.write_baseline}")
        return 0
    if args.baseline is not None:
        if not args.baseline.exists():
            ap.error(f"baseline file not found: {args.baseline}")
        findings = apply_baseline(args.baseline, findings)
    elapsed = time.monotonic() - t0

    print(_RENDERERS[args.format](findings, len(project.files),
                                  elapsed_s=elapsed))
    active, _ = split(findings)
    if args.budget_seconds is not None and elapsed > args.budget_seconds:
        print(f"lint budget exceeded: {elapsed:.2f}s > "
              f"{args.budget_seconds:.2f}s wall-clock budget",
              file=sys.stderr)
        return 1
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
