"""Derived-metric comparison for the BENCH parity gate (a copy of
``benchmarks/_compare.py``: the port imports nothing of the reference).

One definition of "same derived metrics" for the writer's in-process gate
(bit-exact across passes) and for holding a pass to pinned anchors
(rtol-relaxed floats)."""
from __future__ import annotations

import math


def public_derived(derived: dict) -> dict:
    """Derived metrics without "_"-prefixed sidecar entries (phase timings
    ride along in bench results under ``_phases``)."""
    return {k: v for k, v in derived.items() if not k.startswith("_")}


def value_match(a, b, rtol: float = 0.0) -> bool:
    """One metric value: exact by default (NaN == NaN), rtol-relaxed floats
    when asked."""
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) and math.isnan(b):
            return True
        if rtol > 0.0:
            return math.isclose(a, b, rel_tol=rtol, abs_tol=0.0)
    return a == b


def derived_equal(a: dict, b: dict, rtol: float = 0.0) -> bool:
    """Two derived-metric dicts agree on keys and every value."""
    return set(a) == set(b) and all(value_match(a[k], b[k], rtol) for k in a)
