"""Fig 10: Parallelism-axis isolation on MnasNet, 16x64 and 32x32 arrays
(the counterpart of ``benchmarks/fig10_parallelism.py``).

Paper reference: FullFlex-0010 ~1.6x / 1.3x over InFlex/PartFlex; depthwise
Layer-29 starves K-C parallelism; non-conventional pairs (XK, KS, RS) get
picked by the mapper."""
from __future__ import annotations

from typing import Optional

from ..core import (FULLFLEX, PARTFLEX, get_model, make_variant, search,
                    search_model)
from ..core.workloads import DIMS
from .common import MNASNET_LAYERS, Table, find_layer, ga_budget

SHAPES = ((16, 64), (32, 32))
QUOTED = ("layer10", "layer16", "layer29")


def _accels(shape):
    kw = dict(fixed_shape=shape)
    return [
        ("InFlex0010", make_variant("0000", **kw)),
        ("PartFlex0010", make_variant("0010", PARTFLEX, **kw)),
        ("FullFlex0010", make_variant("0010", FULLFLEX, **kw)),
        ("FullFlex1111", make_variant("1111", FULLFLEX, **kw)),
    ]


def run(mode: Optional[str] = None, path: str = "batched", device=None,
        print_fn=print, devices=None) -> dict:
    layers = get_model("mnasnet")
    cfg = ga_budget(mode, path, devices=devices)
    derived = {}
    t = Table("Fig 10 — Parallelism axis isolation (MnasNet)",
              ["array", "accel", "layer", "runtime_rel", "chosen_par"])
    for shape in SHAPES:
        accels = _accels(shape)
        for lname in QUOTED:
            layer = find_layer("mnasnet", MNASNET_LAYERS[lname])
            base = None
            for aname, spec in accels:
                r = search(layer, spec, cfg, device)
                base = base or r
                par = "".join(DIMS[d] for d in r.mapping.parallel)
                t.add(f"{shape[0]}x{shape[1]}", aname, lname,
                      r.runtime / base.runtime, par)
        model_rt = {}
        for aname, spec in accels:
            res = search_model(layers, spec, cfg, device=device)
            model_rt[aname] = res.runtime
            t.add(f"{shape[0]}x{shape[1]}", aname, "model",
                  model_rt[aname] / model_rt["InFlex0010"], "-")
        key = f"{shape[0]}x{shape[1]}"
        derived[f"fullflex_speedup_{key}"] = (model_rt["InFlex0010"]
                                              / model_rt["FullFlex0010"])
        derived[f"ordering_ok_{key}"] = (
            model_rt["FullFlex0010"] <= model_rt["PartFlex0010"] * 1.001
            and model_rt["PartFlex0010"] <= model_rt["InFlex0010"] * 1.001)
    t.show(print_fn)
    return derived
