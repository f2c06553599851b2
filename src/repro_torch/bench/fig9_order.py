"""Fig 9: Order-axis isolation on MnasNet (InFlex/PartFlex/FullFlex-0100)
(the counterpart of ``benchmarks/fig9_order.py``).

Paper reference: InFlex uses output-stationary YXKCRS; PartFlex adds
weight/input-stationary (3 of 720 orders) and lands near FullFlex —
"partially supporting order flexibility may expose a better
cost-performance trade-off"."""
from __future__ import annotations

import time
from typing import Optional

from ..core import (FULLFLEX, PARTFLEX, get_model, make_variant, search,
                    search_model)
from ..core.spec import ORDER_OUTPUT_STATIONARY, perm_to_order_str
from .common import (MNASNET_LAYERS, Table, find_layer, flexion_reports,
                     ga_budget)


def _accels():
    # order-isolation variants share the output-stationary InFlex baseline
    kw = dict(fixed_order=ORDER_OUTPUT_STATIONARY)
    return [
        ("InFlex0100", make_variant("0000", hw=None, **kw)),
        ("PartFlex0100", make_variant("0100", PARTFLEX, **kw)),
        ("FullFlex0100", make_variant("0100", FULLFLEX, **kw)),
        ("FullFlex1111", make_variant("1111", FULLFLEX, **kw)),
    ]


def run(mode: Optional[str] = None, path: str = "batched", device=None,
        print_fn=print, devices=None) -> dict:
    layers = get_model("mnasnet")
    cfg = ga_budget(mode, path, devices=devices)
    accels = _accels()
    t = Table("Fig 9 — Order axis isolation (MnasNet)",
              ["accel", "layer", "runtime_rel", "energy_rel", "W-F(O)",
               "chosen_order"])
    quoted = [("layer16", find_layer("mnasnet", MNASNET_LAYERS["layer16"])),
              ("layer29", find_layer("mnasnet", MNASNET_LAYERS["layer29"]))]
    timings = {}

    # flexion column: one batched campaign over all (layer, accel) pairs on
    # the campaign path, the per-pair loop otherwise — bit-identical
    keys, pairs = zip(*[((aname, lname), (spec, layer))
                        for lname, layer in quoted
                        for aname, spec in accels])
    fx_map = dict(zip(keys, flexion_reports(pairs, 5_000,
                                            path == "campaign", timings,
                                            device=device, devices=devices)))

    t0 = time.time()
    for lname, layer in quoted:
        base = None
        for aname, spec in accels:
            r = search(layer, spec, cfg, device)
            base = base or r
            fx = fx_map[(aname, lname)]
            t.add(aname, lname, r.runtime / base.runtime,
                  r.energy / base.energy, fx.per_axis_wf["O"],
                  perm_to_order_str(r.mapping.order))
    timings["mse_quoted"] = round(time.time() - t0, 6)
    model_rt = {}
    for aname, spec in accels:
        res = search_model(layers, spec, cfg, device=device)
        model_rt[aname] = res.runtime
        t.add(aname, "model", res.runtime / model_rt["InFlex0100"],
              "-", "-", "-")
    t.show(print_fn)
    return {
        "fullflex0100_speedup": model_rt["InFlex0100"]
        / model_rt["FullFlex0100"],
        "partflex_close_to_full": model_rt["PartFlex0100"]
        <= 1.25 * model_rt["FullFlex0100"],
        "_phases": timings,
    }
