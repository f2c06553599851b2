"""Shared bench helpers: budgets, the bench mode, MSE paths, layer lookup
and table printing (the counterpart of ``benchmarks/common.py``)."""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

from ..core.mapper import GAConfig
from ..core.workloads import Layer, get_model

# Budgets: FAST (tests / smoke), DEFAULT (bench runs), FULL (paper 100x100)
BUDGETS = {
    "fast": GAConfig(population=24, generations=10),
    "default": GAConfig(population=48, generations=30),
    "full": GAConfig(population=100, generations=100),
}
MODES = tuple(BUDGETS)

# MSE paths: the serial per-layer engine, the batched engine, and the
# cross-model campaign (batched, all of a bench's searches as one row set)
PATHS = ("serial", "batched", "campaign")


# the reference benches' fast-mode public derived values of the figures
# that BENCH_mapper.json does not pin (fig8, fig9, fig10, fig12, table3),
# generated from benchmarks/*.run() on the CPU (tests/_torch_bench_parity.py
# writes the file, and its parity tests regenerate and compare it)
ANCHORS_PATH = Path(__file__).with_name("anchors_fast.json")


def fast_anchors() -> Dict[str, dict]:
    """bench name -> its pinned fast-mode derived values."""
    with open(ANCHORS_PATH) as f:
        return json.load(f)["derived"]


def bench_mode(mode: Optional[str] = None) -> str:
    """The budget name: ``mode`` when given, else ``"default"``."""
    mode = mode or "default"
    if mode not in BUDGETS:
        raise ValueError(f"unknown bench mode {mode!r}; expected one of "
                         f"{MODES}")
    return mode


def ga_budget(mode: Optional[str] = None, path: str = "batched",
              scale: float = 1.0, devices=None) -> GAConfig:
    """The GA budget of ``mode`` on an MSE ``path``.  The campaign path is
    the batched engine with chunk pipelining on (host draw preparation
    overlapped with device work), as in the reference.  ``devices`` is the
    device pool of the batched chunks (``GAConfig.devices``: a count,
    ``"all"`` or device indices) — with ``path="campaign"`` the reference's
    ``campaign-d4`` pass is ``devices=4``."""
    if path not in PATHS:
        raise ValueError(f"unknown MSE path {path!r}; expected one of "
                         f"{PATHS}")
    base = dataclasses.replace(
        BUDGETS[bench_mode(mode)],
        engine="serial" if path == "serial" else "batched",
        pipeline=path == "campaign", devices=devices)
    if scale != 1.0:
        base = dataclasses.replace(
            base, generations=max(4, int(base.generations * scale)))
    return base


def flexion_reports(pairs, mc_samples: int, campaign: bool,
                    timings: Optional[Dict[str, float]] = None,
                    device=None, devices=None):
    """Flexion reports for ``(spec, layer)`` pairs, in input order: one
    batched ``flexion_campaign`` call on the campaign path, the per-pair
    ``compute_flexion`` loop otherwise — bit-identical either way (every
    row uses seed 0).  ``devices`` is the pass's device pool (the torch
    backend's chunks).  Starts cache-cold so the phase timing compares
    fairly across paths."""
    from ..core.flexion import compute_flexion
    from ..core.flexion_batched import (clear_flexion_reference_cache,
                                        flexion_campaign)
    clear_flexion_reference_cache()
    t0 = time.time()
    if campaign:
        reports = flexion_campaign([(spec, layer, 0) for spec, layer in pairs],
                                   mc_samples=mc_samples, seed=0,
                                   device=device, devices=devices)
    else:
        reports = [compute_flexion(spec, layer, mc_samples=mc_samples,
                                   device=device, devices=devices)
                   for spec, layer in pairs]
    if timings is not None:
        timings["flexion"] = round(time.time() - t0, 6)
    return reports


def find_layer(model: str, dims) -> Layer:
    """Locate a layer by its exact (K,C,Y,X,R,S) tuple (the paper quotes
    layers by dims, e.g. MnasNet Layer-29 = (1,480,14,14,5,5))."""
    for layer in get_model(model):
        if tuple(layer.dims) == tuple(dims):
            return layer
    raise KeyError(f"{dims} not in {model}")


# the paper's quoted MnasNet layers
MNASNET_LAYERS = {
    "layer1": (32, 3, 224, 224, 3, 3),
    "layer10": (72, 24, 56, 56, 1, 1),
    "layer16": (120, 40, 28, 28, 1, 1),
    "layer29": (1, 480, 14, 14, 5, 5),
}


class Table:
    """Collects rows and prints them aligned."""

    def __init__(self, title: str, columns: List[str]):
        self.title = title
        self.columns = columns
        self.rows: List[List] = []

    def add(self, *row):
        self.rows.append(list(row))

    def show(self, print_fn=print):
        print_fn(f"\n== {self.title} ==")
        widths = [max(len(str(c)), *(len(_fmt(r[i])) for r in self.rows))
                  if self.rows else len(str(c))
                  for i, c in enumerate(self.columns)]
        print_fn("  ".join(str(c).ljust(w)
                           for c, w in zip(self.columns, widths)))
        for r in self.rows:
            print_fn("  ".join(_fmt(v).ljust(w)
                               for v, w in zip(r, widths)))


def _fmt(v) -> str:
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1000 or abs(v) < 0.001:
            return f"{v:.3g}"
        return f"{v:.3f}"
    return str(v)
