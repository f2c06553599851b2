"""Diff the derived metrics of two BENCH JSON artifacts.

  python -m repro_torch.bench.diff_bench results/BENCH_torch.json \
      BENCH_mapper.json
  python -m repro_torch.bench.diff_bench --self-check

Compares, for every (engine, bench) pair present in BOTH files, the derived
paper metrics ("_"-prefixed sidecar keys like phase timings are ignored) and
exits nonzero on any mismatch, or when a fresh artifact lacks a metric of
:data:`REQUIRED_KEYS`.  Timings (``us_per_call``) are intentionally NOT
compared: they are machine-dependent; the derived metrics are the
deterministic contract.

``--rtol`` relaxes the float comparison (default 0 = bit-identical); it is
an escape hatch for cross-platform float drift, not the normal mode.

``--self-check`` needs no artifact: it parses the port's ``bench/run.py``
with ``ast`` (nothing of the port is imported) and checks that every
``PARITY_BENCHES`` member has a ``REQUIRED_KEYS`` entry — the same check as
the port's REP006 lint rule.
"""
from __future__ import annotations

import argparse
import ast
import json
import sys
from pathlib import Path

from ..analysis.rules import parity_coverage_gaps
from ._compare import public_derived, value_match

#: the BENCH writer whose PARITY_BENCHES ``--self-check`` covers
RUN_PY = Path(__file__).with_name("run.py")

# schema contract (v5+): metrics every fresh artifact must carry per bench
# (a regression that silently drops the fifth-axis sweep, the W-F columns,
# or the v6 service gates fails here even when the anchor predates them).
# Every PARITY_BENCHES member in bench/run.py must have an entry — the
# REP006 lint rule and `--self-check` enforce the coverage, so a parity
# bench's headline metrics cannot silently drop out of a fresh artifact.
REQUIRED_KEYS = {
    "fig7": ("fullflex1000_speedup", "partflex1000_speedup",
             "ordering_ok"),
    "fig8": ("speedup_1k_to_64k",),
    "fig9": ("fullflex0100_speedup",),
    "fig10": ("fullflex_speedup_16x64", "ordering_ok_16x64",
              "fullflex_speedup_32x32", "ordering_ok_32x32"),
    "fig11": ("fullflex_speedup", "partflexB_close_to_full"),
    "fig12": ("speedup_256_to_1024", "speedup_1024_to_4096"),
    "flexion": ("partflex1000_hf_T", "fullflex1111_hf",
                "campaign_matches_serial", "all_in_unit_interval"),
    "fig13": ("fullflex1111_geomean_future", "fullflex1111_hf",
              "partflex1111_hf", "fullflex11111_geomean_future",
              "fullflex11111_hf", "fullflex1111_wf", "fullflex11111_wf",
              "classes_swept"),
    "table3": ("fullflex_overhead_pct", "rflex_overhead_pct",
               "fullflex5_overhead_pct"),
    # v6: the DSE service bench must prove its contract every run — results
    # bit-identical to solo campaigns, repeats cache-served, and exactly the
    # unique row set dispatched (throughput/speedup stay "_" sidecars)
    "service": ("clients", "queries_per_client", "parity_ok",
                "repeat_cached_ok", "unique_rows"),
    # v7: the measured kernel-autotune pass must prove its contract every
    # run — every lowered config matches the golden oracle, the tuned
    # config is legal, the deterministic config count holds, and predicted
    # runtime ranks measured wall-clock positively per kernel kind (raw
    # correlations/timings stay machine-dependent "measured" columns)
    "autotune": ("parity_ok", "tuned_legal_ok", "configs_measured",
                 "rank_corr_positive_matmul", "rank_corr_positive_attention",
                 "rank_corr_positive_mamba"),
}


def _metrics(cell):
    return public_derived(cell.get("derived", {}))


def missing_required(new: dict):
    """Yields (engine, bench, key) for required v5 keys absent from the
    fresh artifact's cells (anchor cells are exempt: old anchors predate
    the keys, and the union diff already flags asymmetric cells).  The
    port's writer emits schema v7 (``run.BENCH_SCHEMA``)."""
    if str(new.get("schema", "")) < "repro-bench-mapper/v5":
        return
    for engine, benches in new.get("engines", {}).items():
        for bench, keys in REQUIRED_KEYS.items():
            if bench not in benches:
                continue
            got = _metrics(benches[bench])
            for key in keys:
                if key not in got:
                    yield engine, bench, key


def diff(new: dict, anchor: dict, rtol: float = 0.0):
    """Yields (engine, bench, key, new_value, anchor_value) mismatches."""
    for engine, benches in new.get("engines", {}).items():
        anchor_benches = anchor.get("engines", {}).get(engine, {})
        for bench, cell in benches.items():
            if bench not in anchor_benches:
                continue
            got = _metrics(cell)
            want = _metrics(anchor_benches[bench])
            for key in sorted(set(got) | set(want)):
                a, b = got.get(key), want.get(key)
                if not value_match(a, b, rtol):
                    yield engine, bench, key, a, b


def self_check(run_py: Path = RUN_PY) -> int:
    """The REP006 schema-coverage check, standalone: every parity bench in
    ``run_py`` must have a non-empty REQUIRED_KEYS entry.  Parses it with
    ``ast`` and reuses the linter's check."""
    parity = None
    for stmt in ast.parse(Path(run_py).read_text()).body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and stmt.targets[0].id == "PARITY_BENCHES"):
            parity = ast.literal_eval(stmt.value)
    if parity is None:
        print(f"error: PARITY_BENCHES not found in {run_py}",
              file=sys.stderr)
        return 2
    gaps = parity_coverage_gaps(parity, REQUIRED_KEYS)
    for bench in gaps:
        print(f"GAP: parity bench {bench!r} has no REQUIRED_KEYS entry",
              file=sys.stderr)
    if gaps:
        print(f"{len(gaps)} parity bench(es) uncovered", file=sys.stderr)
        return 1
    print(f"OK: all {len(parity)} parity benches have REQUIRED_KEYS "
          f"coverage")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("new", nargs="?", help="freshly generated BENCH JSON")
    ap.add_argument("anchor", nargs="?", help="committed anchor BENCH JSON")
    ap.add_argument("--rtol", type=float, default=0.0,
                    help="relative float tolerance (default: bit-identical)")
    ap.add_argument("--self-check", action="store_true",
                    help="verify PARITY_BENCHES<->REQUIRED_KEYS coverage "
                         "(no artifacts needed) and exit")
    args = ap.parse_args(argv)
    if args.self_check:
        return self_check()
    if args.new is None or args.anchor is None:
        ap.error("new and anchor BENCH JSON paths are required "
                 "(or pass --self-check)")
    with open(args.new) as f:
        new = json.load(f)
    with open(args.anchor) as f:
        anchor = json.load(f)

    mismatches = list(diff(new, anchor, args.rtol))
    compared = sum(1 for e, b in
                   ((e, b) for e, bs in new.get("engines", {}).items()
                    for b in bs)
                   if b in anchor.get("engines", {}).get(e, {}))
    if not compared:
        print("error: no overlapping (engine, bench) pairs to compare",
              file=sys.stderr)
        return 2
    dropped = list(missing_required(new))
    for engine, bench, key in dropped:
        print(f"MISSING [{engine}] {bench}.{key}: required schema-v5 "
              f"metric absent from the fresh artifact", file=sys.stderr)
    if dropped:
        print(f"{len(dropped)} required metric(s) missing", file=sys.stderr)
        return 1
    for engine, bench, key, a, b in mismatches:
        print(f"MISMATCH [{engine}] {bench}.{key}: {a!r} != anchor {b!r}",
              file=sys.stderr)
    if mismatches:
        print(f"{len(mismatches)} derived-metric mismatch(es) across "
              f"{compared} compared cells", file=sys.stderr)
        return 1
    print(f"OK: derived metrics match the anchor across {compared} "
          f"(engine, bench) cells")
    return 0


if __name__ == "__main__":
    sys.exit(main())
