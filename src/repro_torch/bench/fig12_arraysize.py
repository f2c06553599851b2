"""Fig 12: array-size sensitivity of fully-shape-flexible accelerators (the
counterpart of ``benchmarks/fig12_arraysize.py``).  Larger PE arrays expose
more shapes (higher H-F) but utilization returns diminish once parallelism
dims are exhausted (~45x45-64x64 in the paper)."""
from __future__ import annotations

from typing import Optional

from ..core import (FULLFLEX, HWConfig, get_model, make_variant,
                    search_model)
from .common import Table, ga_budget

PE_COUNTS = (256, 1024, 2048, 4096)


def run(mode: Optional[str] = None, path: str = "batched", device=None,
        print_fn=print, devices=None) -> dict:
    """Two series: S-only flex (plateaus once the array covers the fixed
    tile — the formalism keeps T frozen in class-0001) and T+S flex (the
    paper's rising-then-diminishing curve: bigger arrays pay off until the
    layers' parallelism is exhausted)."""
    layers = get_model("mnasnet")
    cfg = ga_budget(mode, path, scale=0.5, devices=devices)
    t = Table("Fig 12 — array-size sensitivity (MnasNet)",
              ["class", "num_pes", "runtime", "speedup_vs_256",
               "macs_per_pe_cycle"])
    series = {}
    for cls in ("0001", "1001"):
        runtimes = []
        for pes in PE_COUNTS:
            spec = make_variant(cls, FULLFLEX, hw=HWConfig(num_pes=pes))
            res = search_model(layers, spec, cfg, device=device)
            runtimes.append(res.runtime)
            t.add(f"FullFlex{cls}", pes, res.runtime,
                  runtimes[0] / res.runtime,
                  round(sum(l.macs for l in layers) / res.runtime / pes, 3))
        series[cls] = runtimes
    t.show(print_fn)
    rt = series["1001"]
    s_small = rt[0] / rt[1]
    s_big = rt[1] / rt[3]
    return {"speedup_256_to_1024": s_small,
            "speedup_1024_to_4096": s_big,
            "diminishing_returns": s_big < s_small,
            "s_only_plateaus": series["0001"][1] / series["0001"][3] < 1.5}
