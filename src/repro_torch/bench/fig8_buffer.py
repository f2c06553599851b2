"""Fig 8: buffer-size sensitivity of fully-tile-flexible accelerators (the
counterpart of ``benchmarks/fig8_buffer.py``).  Runtime improves and W-F
rises with buffer size, saturating once most MnasNet layers fit (~6.4KB in
the paper)."""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..core import FULLFLEX, HWConfig, get_model, make_variant, search_model
from .common import Table, flexion_reports, ga_budget

SIZES_KB = (1, 2, 4, 8, 16, 64)


def run(mode: Optional[str] = None, path: str = "batched", device=None,
        print_fn=print, devices=None) -> dict:
    layers = get_model("mnasnet")
    cfg = ga_budget(mode, path, scale=0.5, devices=devices)
    specs = [make_variant("1000", FULLFLEX, hw=HWConfig(buffer_bytes=kb * 1024))
             for kb in SIZES_KB]
    probe_layers = layers[::4]
    t = Table("Fig 8 — buffer-size sensitivity (FullFlex-1000, MnasNet)",
              ["buffer_kb", "runtime", "runtime_rel", "W-F(T)"])
    timings = {}

    # W-F of the T axis (the flexible axis in this isolation study): one
    # campaign over all (buffer size, probe layer) rows on the campaign
    # path — each HWConfig samples its C_X reference once — or the per-pair
    # loop; bit-identical either way
    reports = flexion_reports([(spec, l) for spec in specs
                               for l in probe_layers], 5_000,
                              path == "campaign", timings, device=device,
                              devices=devices)
    wf_t = {spec.hw.buffer_bytes: float(np.mean(
        [r.per_axis_wf["T"]
         for r in reports[si * len(probe_layers):
                          (si + 1) * len(probe_layers)]]))
        for si, spec in enumerate(specs)}

    t0 = time.time()
    runtimes, wfs = [], []
    for kb, spec in zip(SIZES_KB, specs):
        res = search_model(layers, spec, cfg, device=device)
        runtimes.append(res.runtime)
        wfs.append(wf_t[spec.hw.buffer_bytes])
        t.add(kb, res.runtime, res.runtime / runtimes[0],
              round(wfs[-1], 4))
    timings["mse_sweep"] = round(time.time() - t0, 6)
    t.show(print_fn)
    return {
        "monotone_runtime": all(runtimes[i + 1] <= runtimes[i] * 1.05
                                for i in range(len(runtimes) - 1)),
        "wf_increases": wfs[-1] > wfs[0],
        "speedup_1k_to_64k": runtimes[0] / runtimes[-1],
        "_wf_t": wfs,
        "_phases": timings,
    }
