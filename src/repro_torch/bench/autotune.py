"""Autotune pass: predicted-vs-measured rank correlation and measured GA
tuning per kernel kind (matmul / attention / mamba), the counterpart of
``benchmarks/autotune_bench.py``.

  * rank correlation — sample genomes, lower each to its kernel config,
    and Spearman-correlate the cost model's predicted runtime with the
    measured kernel time per distinct config (CUDA events on the card);
  * golden parity — every config the study measures, and the tuned one,
    runs against the ``kernels/ref`` oracle (``parity_ok``);
  * measured tuning — ``tune_kernel`` runs the GA with measured time as the
    objective, reusing the study's timing cache; the tuned config must be
    legal (``tuned_legal_ok``).

Derived keys (the reference's schema v7):
  parity_ok, tuned_legal_ok, configs_measured,
  rank_corr_positive_{matmul,attention,mamba}
  _rank_corr_*, _tuned_us_*, _default_us_*, _tuned_speedup_* (sidecars)
plus ``_runs`` (per kind: the workload, runner, study and tuned result,
for a caller that checks every timed config further).

The workload shapes are an argument (``shapes``): the per-mode defaults
are the reference's small shapes; a card run passes full-width ones.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .common import BUDGETS, Table, bench_mode

SHAPES = {
    "fast": {"matmul": (128, 128, 128), "attention": (2, 128, 32),
             "mamba": (1, 64, 32, 8)},
    "default": {"matmul": (256, 256, 128), "attention": (4, 256, 64),
                "mamba": (2, 128, 64, 16)},
    "full": {"matmul": (512, 512, 256), "attention": (4, 512, 64),
             "mamba": (2, 256, 128, 16)},
}
N_SAMPLES = {"fast": 12, "default": 16, "full": 24}
TUNE_POP_GENS = {"fast": (10, 4), "default": (16, 6), "full": (24, 8)}
KINDS = ("matmul", "attention", "mamba")


def run(mode: Optional[str] = None,
        shapes: Optional[Dict[str, Tuple[int, ...]]] = None, device=None,
        timer: Optional[Callable[[tuple], float]] = None,
        force_available: Optional[bool] = None, print_fn=print) -> dict:
    """One autotune pass.  ``timer`` and ``force_available`` go to every
    :class:`MeasuredRunner` (a frozen timer makes the pass deterministic);
    ``device`` is where inputs live and kernels run (``None``: the card)."""
    from ..core import HWConfig, make_variant, mapspace_for
    from ..core.kernel_bridge import (KernelWorkload, MeasuredRunner,
                                      config_legal, lower_mapping,
                                      parity_check, rank_correlation_study,
                                      tune_kernel)

    mode = bench_mode(mode)
    shapes = shapes or SHAPES[mode]
    # T/O open at a pinned fp32 width: exactly the axes the kernels realize
    # (P/S are mesh-level; an open R would mix executed dtypes into one
    # correlation)
    spec = make_variant("1100", hw=HWConfig(), fixed_bits=32)
    n_samples = N_SAMPLES[mode]
    pop, gens = TUNE_POP_GENS[mode]
    tune_cfg = dataclasses.replace(BUDGETS[mode], population=pop,
                                   generations=gens, engine="serial")

    def runner():
        return MeasuredRunner(repeats=2, warmup=1, timer=timer,
                              force_available=force_available,
                              device=device)

    derived = {
        "parity_ok": False, "tuned_legal_ok": False,
        "configs_measured": 0,
        "rank_corr_positive_matmul": False,
        "rank_corr_positive_attention": False,
        "rank_corr_positive_mamba": False,
    }
    derived["kernels_available"] = runner().available()
    if not derived["kernels_available"]:
        print_fn("[autotune] no kernels to time (a CPU device or "
                 "REPRO_NO_KERNELS) — skipping measurements")
        return derived

    t = Table(f"autotune: predicted vs measured ({mode})",
              ["kernel", "shape", "configs", "spearman", "tuned config",
               "tuned_us", "default_us", "speedup", "parity"])
    parity_all = True
    legal_all = True
    configs_total = 0
    runs = {}
    for kind in KINDS:
        wl = KernelWorkload(kind, tuple(shapes[kind]))
        rn = runner()
        study = rank_correlation_study(wl, spec, n_samples=n_samples,
                                       seed=0, runner=rn)
        corr = study["spearman"]
        configs_total += study["n_configs"]
        derived[f"rank_corr_positive_{kind}"] = bool(corr > 0.0)
        derived[f"_rank_corr_{kind}"] = round(corr, 4)

        # golden parity of every measured config (one shared input set)
        inputs = rn.inputs_for(wl)
        kind_parity = all(parity_check(wl, kcfg, inputs)[0]
                          for kcfg in study["configs"])

        # measured-objective tuning, reusing the study's timing cache
        tuned = tune_kernel(wl, spec, tune_cfg, rn)
        legal_all &= config_legal(wl, tuned.config)
        kind_parity &= parity_check(wl, tuned.config, inputs)[0]
        parity_all &= kind_parity

        # max-block default (full-dim tiles) as the speedup baseline
        space = mapspace_for(wl.layer, spec)
        default_cfg = lower_mapping(wl, space.decode(
            space.clip(np.concatenate([space.dims,
                                       [0, 0, 0, 0]])[None, :])[0]))
        default_s = rn.measure(wl, default_cfg)
        derived[f"_tuned_us_{kind}"] = round(tuned.best_cost * 1e6, 1)
        derived[f"_default_us_{kind}"] = round(default_s * 1e6, 1)
        derived[f"_tuned_speedup_{kind}"] = round(
            default_s / max(tuned.best_cost, 1e-12), 2)
        runs[kind] = {"workload": wl, "runner": rn, "study": study,
                      "tuned": tuned}
        t.add(kind, wl.shape, study["n_configs"], round(corr, 3),
              f"{tuned.config.block} {tuned.config.order}".strip(),
              round(tuned.best_cost * 1e6, 1), round(default_s * 1e6, 1),
              derived[f"_tuned_speedup_{kind}"], kind_parity)

    derived["parity_ok"] = bool(parity_all)
    derived["tuned_legal_ok"] = bool(legal_all)
    derived["configs_measured"] = int(configs_total)
    derived["_runs"] = runs
    t.show(print_fn)
    return derived
