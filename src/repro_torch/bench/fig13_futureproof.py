"""Fig 13 / Sec 7: future-proofing a 2014 AlexNet-optimized accelerator (the
counterpart of ``benchmarks/fig13_futureproof.py``).

Rows: InFlex-0000-Alexnet-Opt (the hardened 2014 design), InFlex-0000-X-Opt
(re-designed per future model), and flexible variants of the 2014 design.
Values: runtime normalized to the 2014 design per model.  Paper headline:
FullFlex-1111 gains 11.8x geomean on future DNNs.  The sweep covers the
fifth representation axis too: every T/O/P/S class also runs with the R bit
set (31 nonzero classes + the InFlex-00000 baseline row), and each row
carries both flexion columns (H-F and the future-suite W-F).
"""
from __future__ import annotations

from typing import Optional

from ..core import (clear_flexion_reference_cache, future_proofing_study,
                    geomean_speedup)
from .common import Table, ga_budget

# the paper's 15 nonzero T/O/P/S classes (R pinned)
CLASSES_TOPS = ("1000", "0100", "0010", "0001", "0011", "0101", "1001",
                "0110", "1010", "1100", "1110", "1011", "0111", "1101",
                "1111")
# the 16 R-open classes: every T/O/P/S prefix with the R bit set
CLASSES_R = tuple(f"{i:04b}1" for i in range(16))
CLASSES_5AXIS = CLASSES_TOPS + CLASSES_R

MODELS = ("alexnet", "mnasnet", "resnet50", "mobilenetv2", "bert",
          "dlrm", "ncf")

BASE = "alexnet"


def run(mode: Optional[str] = None, path: str = "batched", device=None,
        print_fn=print, devices=None) -> dict:
    cfg = ga_budget(mode, path, scale=0.5, devices=devices)
    models = MODELS
    timings = {}
    flexion = {}
    wflexion = {}
    # cache-cold so the recorded flexion phase is reproducible
    clear_flexion_reference_cache()
    table = future_proofing_study(
        base_model=BASE, future_models=models, class_strs=CLASSES_5AXIS,
        cfg=cfg, campaign=path == "campaign", timings=timings,
        flexion=flexion, wflexion=wflexion, device=device)

    t = Table("Fig 13 — runtime normalized to InFlex0000-Alexnet-Opt",
              ["accel"] + list(models) + ["geomean_speedup", "H-F", "W-F"])
    derived = {}
    for row_name, cols in table.items():
        gm = geomean_speedup(table, row_name)
        t.add(row_name, *[round(cols[m], 4) for m in models], round(gm, 2),
              flexion.get(row_name, float("nan")),
              wflexion.get(row_name, float("nan")))
        derived[row_name] = gm
    t.show(print_fn)

    full_row = f"FullFlex1111-{BASE}-Opt"
    full5_row = f"FullFlex11111-{BASE}-Opt"
    part_row = f"PartFlex1111-{BASE}-Opt"
    future = [m for m in models if m != BASE]
    out = {
        "fullflex1111_geomean_future": geomean_speedup(table, full_row,
                                                       future),
        "fullflex1111_geomean_all": derived.get(full_row, float("nan")),
        "beats_inflex_everywhere": all(
            table[full_row][m] <= 1.001 for m in models),
        "fullflex1111_hf": flexion[full_row],
        "partflex1111_hf": flexion.get(part_row, float("nan")),
        "fullflex11111_geomean_future": geomean_speedup(table, full5_row,
                                                        future),
        "fullflex11111_hf": flexion[full5_row],
        "fullflex1111_wf": wflexion[full_row],
        "fullflex11111_wf": wflexion[full5_row],
        "partflex1111_wf": wflexion.get(part_row, float("nan")),
        "classes_swept": len(CLASSES_5AXIS) + 1,
    }
    out["_phases"] = timings
    return out
