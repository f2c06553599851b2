"""Flexion pass: the batched MC campaign vs the serial per-row loop (the
counterpart of ``benchmarks/flexion_bench.py``).

Times the same flexion row grid — the fig7 tile-isolation accelerators on
the paper's quoted MnasNet layers, plus their workload-agnostic reports —
three ways: the per-row loop with the reference cache cleared per call,
the per-row loop with the shared cache, and the batched campaign.  Checks
that the serial and campaign paths are bit-identical and that every
fraction lies in [0, 1].  The derived metrics are deterministic (fixed
seeds, engine-independent).
"""
from __future__ import annotations

import time
from typing import Optional

from ..core import (FULLFLEX, PARTFLEX, clear_flexion_reference_cache,
                    compute_flexion, flexion_campaign, inflex_baseline,
                    make_variant)
from .common import MNASNET_LAYERS, Table, bench_mode, find_layer

# paper-scale sampling only in full mode; fast keeps smoke runs quick
MC_BY_MODE = {"fast": 20_000, "default": 50_000, "full": 200_000}

ACCELS = (
    ("InFlex1000", lambda: inflex_baseline()),
    ("PartFlex1000", lambda: make_variant("1000", PARTFLEX)),
    ("FullFlex1000", lambda: make_variant("1000", FULLFLEX)),
    ("PartFlex1111", lambda: make_variant("1111", PARTFLEX)),
    ("FullFlex1111", lambda: make_variant("1111", FULLFLEX)),
)
QUOTED = ("layer1", "layer16", "layer29")


def _rows():
    specs = [(name, mk()) for name, mk in ACCELS]
    layers = ([(ln, find_layer("mnasnet", MNASNET_LAYERS[ln]))
               for ln in QUOTED] + [("agnostic", None)])
    return [(aname, spec, lname, layer)
            for lname, layer in layers for aname, spec in specs]


def run(mode: Optional[str] = None, device=None, print_fn=print,
        devices=None) -> dict:
    """``device`` picks the predicate backend (float64 numpy for a CPU
    device, float32 torch on a card; ``REPRO_FLEXION_BACKEND`` forces
    one), and ``devices`` is the torch backend's device pool.  The flexion
    pass has no MSE, so it takes no path."""
    mc = MC_BY_MODE[bench_mode(mode)]
    rows = _rows()
    fx_rows = [(spec, layer, 0) for _, spec, _, layer in rows]

    t0 = time.time()
    for _, spec, _, layer in rows:
        clear_flexion_reference_cache()
        compute_flexion(spec, layer, mc_samples=mc, seed=0, device=device,
                        devices=devices)
    t_uncached = time.time() - t0

    clear_flexion_reference_cache()
    t0 = time.time()
    serial = [compute_flexion(spec, layer, mc_samples=mc, seed=0,
                              device=device, devices=devices)
              for _, spec, _, layer in rows]
    t_serial = time.time() - t0

    clear_flexion_reference_cache()
    t0 = time.time()
    batched = flexion_campaign(fx_rows, mc_samples=mc, seed=0, device=device,
                               devices=devices)
    t_batched = time.time() - t0

    t = Table(f"Flexion — campaign vs serial ({len(rows)} rows, "
              f"{mc} MC samples)",
              ["accel", "layer", "H-F", "W-F", "H-F(T)", "W-F(T)"])
    for (aname, _, lname, _), rep in zip(rows, batched):
        t.add(aname, lname, rep.hf, rep.wf, rep.per_axis_hf["T"],
              rep.per_axis_wf["T"])
    t.show(print_fn)
    print_fn(f"serial-uncached {t_uncached * 1e3:.1f}ms  serial "
             f"{t_serial * 1e3:.1f}ms  campaign {t_batched * 1e3:.1f}ms")

    by_name = {(aname, lname): rep
               for (aname, _, lname, _), rep in zip(rows, batched)}
    bounded = all(0.0 <= v <= 1.0 for rep in batched
                  for v in (rep.hf, rep.wf, *rep.per_axis_hf.values(),
                            *rep.per_axis_wf.values()))
    return {
        "campaign_matches_serial": batched == serial,
        "all_in_unit_interval": bounded,
        "partflex1000_hf_T": by_name[("PartFlex1000",
                                      "agnostic")].per_axis_hf["T"],
        "fullflex1111_hf": by_name[("FullFlex1111", "agnostic")].hf,
        "_reports": {key: rep for key, rep in by_name.items()},
        "_phases": {"flexion_serial_uncached": round(t_uncached, 6),
                    "flexion_serial": round(t_serial, 6),
                    "flexion_campaign": round(t_batched, 6)},
    }
