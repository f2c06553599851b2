"""The batched engine's chunk pipeline under ``torch.profiler``.

fig13's flexible-variant sweep rows run through ``run_batched_ga`` with the
pipeline off and on, ``CHUNKS`` chunks each way, traced: how much of the
host's chunk preparation ran while a kernel was on the card, and the card's
idle share over the traced window.  A one-off reading, not a standing
check; needs one card:

    PYTHONPATH=src python -m repro_torch.bench.pipeline_trace
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import tempfile
import time

CHUNKS = 8      # enough chunks for the queue to reach its depth each way


def sweep_rows():
    """fig13's flexible-variant sweep as one engine row set: the 32 classes
    (and PartFlex-1111) opened on the InFlex baseline, on all 7 models, at
    fig13's fast budget on the campaign path."""
    from ..core import (FULLFLEX, PARTFLEX, get_model, inflex_baseline,
                        open_axes, plan_model_rows, request_rows)
    from .common import ga_budget
    from .fig13_futureproof import CLASSES_5AXIS, MODELS
    base = inflex_baseline()
    specs = [open_axes(base, cs, FULLFLEX) for cs in CLASSES_5AXIS]
    specs.append(open_axes(base, "1111", PARTFLEX))
    cfg = ga_budget("fast", "campaign", scale=0.5)
    rows = []
    for m in MODELS:
        layers = get_model(m)
        row_index, _ = plan_model_rows(layers)
        for spec in specs:
            rows.extend(request_rows(layers, spec, cfg, row_index))
    return rows, cfg


def trace_overlap(events, wall: float) -> str:
    """Host chunk preparation against kernel time in a chrome trace."""
    def spans(pred):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("ph") == "X" and pred(e))

    kernels = spans(lambda e: e.get("cat") == "kernel")
    preps = spans(lambda e: e.get("name") == "prepare_chunk"
                  and e.get("cat") == "user_annotation")
    if not kernels or not preps:
        return (f"no {'kernels' if not kernels else 'preparation spans'} "
                f"in the trace")
    busy = []
    for a, b in kernels:                      # union of kernel intervals
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    prep_us = sum(b - a for a, b in preps)
    overlap_us = sum(max(0.0, min(b, y) - max(a, x))
                     for a, b in preps for x, y in busy)
    lo = min(min(a for a, _ in preps), busy[0][0])
    hi = max(max(b for _, b in preps), busy[-1][1])
    busy_us = sum(y - x for x, y in busy)
    return (f"wall {wall:.3f} s; host preparation {prep_us / 1e3:.1f} ms, "
            f"{overlap_us / 1e3:.1f} ms of it ({overlap_us / prep_us:.1%}) "
            f"while a kernel ran; {len(kernels)} kernels, card busy "
            f"{busy_us / 1e3:.1f} ms of {(hi - lo) / 1e3:.1f} ms traced "
            f"(idle share {1 - busy_us / (hi - lo):.1%})")


def run(device=None, print_fn=print) -> None:
    """Trace ``CHUNKS`` sweep chunks with the pipeline off, then on."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..core import engine
    from ..device import resolve_device
    device = resolve_device(device)
    rows, cfg = sweep_rows()
    real = engine._prepare_chunk

    def traced(*a, **k):
        with record_function("prepare_chunk"):
            return real(*a, **k)

    part = rows[:CHUNKS * engine.ROW_BUCKET]
    engine.warmup_engine(cfg, device=device)
    engine._prepare_chunk = traced
    try:
        for pipeline in (False, True):
            c = dataclasses.replace(cfg, pipeline=pipeline)
            engine.run_batched_ga(part[:engine.ROW_BUCKET], c,
                                  device=device)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                engine.run_batched_ga(part, c, device=device)
                wall = time.perf_counter() - t0
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            print_fn(f"[pipeline trace] pipeline "
                     f"{'on' if pipeline else 'off'}, {CHUNKS} chunks "
                     f"(P={cfg.population}, G={cfg.generations}): "
                     f"{trace_overlap(events, wall)}")
    finally:
        engine._prepare_chunk = real


def main() -> int:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
