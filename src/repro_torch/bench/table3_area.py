"""Table 3: area cost of accelerators with different flexibility support
(the counterpart of ``benchmarks/table3_area.py``).  The area model is host
arithmetic, so the table takes no MSE path and no device."""
from __future__ import annotations

from ..core import (FULLFLEX, PARTFLEX, area_of, inflex_baseline,
                    make_variant)
from .common import Table


def run(print_fn=print) -> dict:
    rows = [
        ("InFlex", inflex_baseline()),
        ("T-Flex", make_variant("1000")),
        ("O-Flex", make_variant("0100")),
        ("P-Flex", make_variant("0010")),
        ("S-Flex", make_variant("0001")),
        # fifth axis: per-PE subword gating muxes + a width-select register
        ("R-Flex", make_variant("00001")),
        ("PartFlex", make_variant("1111", PARTFLEX)),
        ("FullFlex", make_variant("1111", FULLFLEX)),
        ("FullFlex5", make_variant("11111", FULLFLEX)),
    ]
    base = area_of(rows[0][1]).total_area
    t = Table("Table 3 — area cost of flexibility",
              ["accel", "area_um2", "overhead_pct", "power_uW"])
    derived = {}
    for name, spec in rows:
        r = area_of(spec)
        pct = 100.0 * (r.total_area - base) / base
        t.add(name, round(r.total_area), round(pct, 3),
              round(r.total_power))
        derived[name] = pct
    t.show(print_fn)
    # paper claim: overheads are low (<1%) for single axes; FullFlex ~0.37%
    # (the fifth axis stays inside the same envelope: FullFlex5 < 2%)
    derived["claim_all_under_2pct"] = all(
        v < 2.0 for k, v in derived.items() if k != "InFlex")
    return {"fullflex_overhead_pct": derived["FullFlex"],
            "rflex_overhead_pct": derived["R-Flex"],
            "fullflex5_overhead_pct": derived["FullFlex5"],
            "claim_all_under_2pct": derived["claim_all_under_2pct"]}
