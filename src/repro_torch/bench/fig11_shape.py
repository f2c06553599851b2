"""Fig 11: Shape-axis isolation on MnasNet (1024 PEs, K-C parallelism) (the
counterpart of ``benchmarks/fig11_shape.py``).

Paper reference: PartFlex-0001-B (4x4 building block) nearly matches
FullFlex-0001 with ~6% of the shape flexibility; InFlex is a 32x32 square.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

from ..core import (FULLFLEX, PARTFLEX, get_model, make_variant, search,
                    search_model)
from .common import Table, find_layer, flexion_reports, ga_budget

# expansion / projection layers with skewed (K, C) the paper highlights
LAYERS = {
    "expand_72x24": (72, 24, 56, 56, 1, 1),
    "expand_120x40": (120, 40, 28, 28, 1, 1),
    "project_80x480": (80, 480, 14, 14, 1, 1),
}


def _accels():
    kw = dict(fixed_shape=(32, 32))
    a = [("InFlex0001", make_variant("0000", **kw))]
    pa = make_variant("0001", PARTFLEX, **kw)
    pa = dataclasses.replace(pa, name="PartFlex0001A", shape=dataclasses
                             .replace(pa.shape, building_block=16))
    pb = make_variant("0001", PARTFLEX, **kw)
    pb = dataclasses.replace(pb, name="PartFlex0001B", shape=dataclasses
                             .replace(pb.shape, building_block=4))
    a += [("PartFlex0001A", pa), ("PartFlex0001B", pb),
          ("FullFlex0001", make_variant("0001", FULLFLEX, **kw)),
          ("FullFlex1111", make_variant("1111", FULLFLEX, **kw))]
    return a


def run(mode: Optional[str] = None, path: str = "batched", device=None,
        print_fn=print, devices=None) -> dict:
    layers = get_model("mnasnet")
    cfg = ga_budget(mode, path, devices=devices)
    accels = _accels()
    t = Table("Fig 11 — Shape axis isolation (MnasNet, 1024 PEs)",
              ["accel", "layer", "runtime_rel", "H-F(S)", "chosen_shape"])
    quoted = [(lname, find_layer("mnasnet", dims))
              for lname, dims in LAYERS.items()]
    timings = {}

    # flexion column: one batched campaign over all (layer, accel) pairs on
    # the campaign path, the per-pair loop otherwise — bit-identical.  (The
    # displayed H-F(S) fractions are exact; 20K MC samples match fig7's
    # budget so the phase timing reflects a real estimator workload.)
    keys, pairs = zip(*[((aname, lname), (spec, layer))
                        for lname, layer in quoted
                        for aname, spec in accels])
    fx_map = dict(zip(keys, flexion_reports(pairs, 20_000,
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
                  fx.per_axis_hf["S"], f"{r.mapping.shape}")
    timings["mse_quoted"] = round(time.time() - t0, 6)
    t0 = time.time()
    model_rt = {}
    for aname, spec in accels:
        res = search_model(layers, spec, cfg, device=device)
        model_rt[aname] = res.runtime
        t.add(aname, "model", model_rt[aname] / model_rt["InFlex0001"],
              "-", "-")
    timings["mse_model"] = round(time.time() - t0, 6)
    t.show(print_fn)
    return {
        "fullflex_speedup": model_rt["InFlex0001"] / model_rt["FullFlex0001"],
        "partflexB_close_to_full": model_rt["PartFlex0001B"]
        <= 1.15 * model_rt["FullFlex0001"],
        "_phases": timings,
    }
