"""Fig 7: Tile-axis isolation on MnasNet (InFlex/PartFlex/FullFlex-1000 and
FullFlex-1111), with H-F / W-F flexion quantification (the counterpart of
``benchmarks/fig7_tile.py``).

Paper reference points: PartFlex-1000 H-F ~0.22 (1:1:1 hard partition);
FullFlex-1000 ~4.8x over InFlex end-to-end; PartFlex strictly between.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

from ..core import (FULLFLEX, PARTFLEX, get_model, inflex_baseline,
                    make_variant, search, search_campaign, search_model,
                    search_specs_batched)
from .common import (MNASNET_LAYERS, Table, find_layer, flexion_reports,
                     ga_budget)


def run(mode: Optional[str] = None, path: str = "batched", device=None,
        print_fn=print, devices=None) -> dict:
    layers = get_model("mnasnet")
    cfg = ga_budget(mode, path, devices=devices)
    campaign = path == "campaign"
    accels = [
        ("InFlex1000", inflex_baseline()),
        ("PartFlex1000", make_variant("1000", PARTFLEX)),
        ("FullFlex1000", make_variant("1000", FULLFLEX)),
        ("FullFlex1111", make_variant("1111", FULLFLEX)),
    ]
    specs = [spec for _, spec in accels]
    quoted = [("layer1", MNASNET_LAYERS["layer1"]),
              ("layer16", MNASNET_LAYERS["layer16"]),
              ("layer29", MNASNET_LAYERS["layer29"])]

    t = Table("Fig 7 — Tile axis isolation (MnasNet)",
              ["accel", "layer", "runtime_rel", "energy_rel", "edp_rel",
               "H-F(T)", "W-F(T)", "chosen_tile"])
    derived = {}
    timings = {}

    # per-layer columns: one batched MSE over all (layer, accel) rows; the
    # campaign packs them AND the end-to-end model sweep into one row set
    quoted_layers = [find_layer("mnasnet", dims) for _, dims in quoted]
    t0 = time.time()
    if campaign:
        reqs = ([(quoted_layers, spec) for spec in specs]
                + [(layers, spec) for spec in specs])
        all_res = search_campaign(reqs, cfg, device=device)
        per_spec = all_res[:len(specs)]
        model_res = dict(zip((a for a, _ in accels), all_res[len(specs):]))
        results = {(a, ln): per_spec[ai].per_layer[li]
                   for ai, (a, _) in enumerate(accels)
                   for li, (ln, _) in enumerate(quoted)}
    elif cfg.engine == "batched":
        per_spec = search_specs_batched(quoted_layers, specs, cfg,
                                        device=device)
        results = {(a, ln): per_spec[ai].per_layer[li]
                   for ai, (a, _) in enumerate(accels)
                   for li, (ln, _) in enumerate(quoted)}
    else:
        # same per-layer seed convention as the batched branch
        # (cfg.seed + 1000 * layer index)
        results = {(a, ln): search(
            layer, spec, dataclasses.replace(cfg, seed=cfg.seed + 1000 * li),
            device)
            for a, spec in accels
            for li, ((ln, _), layer) in enumerate(zip(quoted, quoted_layers))}
    timings["mse_campaign" if campaign else "mse_quoted"] = round(
        time.time() - t0, 6)
    keys, pairs = zip(*[((aname, lname), (spec, quoted_layers[li]))
                        for li, (lname, _) in enumerate(quoted)
                        for aname, spec in accels])
    fx_map = dict(zip(keys, flexion_reports(pairs, 20_000, campaign,
                                            timings, device=device)))
    for lname, dims in quoted:
        base = results[("InFlex1000", lname)]
        for aname, spec in accels:
            r = results[(aname, lname)]
            fx = fx_map[(aname, lname)]
            t.add(aname, lname, r.runtime / base.runtime,
                  r.energy / base.energy, r.edp / base.edp,
                  fx.per_axis_hf["T"], fx.per_axis_wf["T"],
                  str(r.mapping.tiles))

    # end-to-end model (already searched by the campaign row set above)
    t0 = time.time()
    if not campaign:
        if cfg.engine == "batched":
            model_res = dict(zip((a for a, _ in accels),
                                 search_specs_batched(layers, specs, cfg,
                                                      device=device)))
        else:
            model_res = {a: search_model(layers, spec, cfg, device=device)
                         for a, spec in accels}
        timings["mse_model"] = round(time.time() - t0, 6)
    model_rt = {}
    for aname, _ in accels:
        res = model_res[aname]
        model_rt[aname] = res.runtime
        t.add(aname, "model", res.runtime / model_rt["InFlex1000"],
              res.energy, "-", "-", "-", "-")
    t.show(print_fn)

    derived["fullflex1000_speedup"] = (model_rt["InFlex1000"]
                                       / model_rt["FullFlex1000"])
    derived["partflex1000_speedup"] = (model_rt["InFlex1000"]
                                       / model_rt["PartFlex1000"])
    derived["ordering_ok"] = (model_rt["FullFlex1111"]
                              <= model_rt["FullFlex1000"]
                              and model_rt["FullFlex1000"]
                              <= model_rt["PartFlex1000"] * 1.001
                              and model_rt["PartFlex1000"]
                              <= model_rt["InFlex1000"] * 1.001)
    derived["_phases"] = timings
    return derived
