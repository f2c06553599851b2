"""Benchmark runner — one module per paper table/figure (the counterpart of
``benchmarks/run.py``).

Prints ``name,us_per_call,derived`` CSV at the end (us_per_call = wall time
of the whole table/figure reproduction; derived = its headline metric).

  python -m repro_torch.bench.run                 # every bench, batched
  python -m repro_torch.bench.run table3 fig7     # a subset
  python -m repro_torch.bench.run --mode fast     # GA budgets: fast|default|full

Machine-readable perf trajectory, on the card:

  python -m repro_torch.bench.run fig7 fig11 fig13 flexion --mode fast \\
      --engines serial,batched --campaign --devices 4 --service 4 \\
      --autotune --json results/BENCH_torch.json

runs every selected bench once per pass (one ``batched`` pass without
``--engines``).  A pass is an MSE path:
``serial`` and ``batched`` (the two engines), ``--campaign`` the
cross-model campaign path (batched engine, chunk pipelining, whole-sweep
row sets), and ``--devices N|all|i,j`` a ``campaign-dN`` pass whose chunks
round-robin over a device pool (``(0, 0)`` is a depth-2 queue on one card).
``--service N`` adds the DSE service bench (N concurrent clients vs N
sequential campaigns), and ``--autotune`` adds ONE post-loop pass of the
measured kernel-autotune bench at the reference's shapes
(predicted-vs-measured rank correlation, golden parity, measured GA
tuning) under its own ``autotune`` label.  ``--json`` writes the BENCH
artifact (schema v7: per-pass per-bench ``us_per_call``, derived metrics,
phases, speedups between passes and a ``device_scaling`` block).

All passes must agree on every derived metric of the engine-driven benches
(the engines' golden-parity contract); any mismatch, or any bench that
raises, makes the run exit 1.

Where it differs from the reference, on purpose:
  * the mode, the passes, the device pool and the service's client count
    are arguments (``--mode``, ``--engines``/``--campaign``,
    ``--devices``, ``--service``; the reference reads
    ``REPRO_BENCH_MODE``, ``REPRO_ENGINE``, ``REPRO_CAMPAIGN`` and
    ``REPRO_SERVICE_CLIENTS``).  Each bench's ``run`` gets ``mode``,
    ``path``, ``devices``, ``clients`` and ``device`` (the ones its
    signature takes), and a pass's pool reaches every layer that places
    work: the engine, the fixed-genome replay and the flexion campaign.
    No environment variable is flipped between passes, and a set
    ``REPRO_DEVICES`` is refused (exit 2): it would pool every pass;
  * the warm-up is not best-effort: a failed warm-up fails the run;
  * ``device_scaling.devices_available`` is the port's pool over every
    local device (``torch.cuda.device_count()`` on the card, 1 on a CPU
    call);
  * there is no persistent compilation cache to enable: the port compiles
    nothing at run time apart from the kernels' nvcc build, which
    ``kernels/_build.py`` already caches;
  * the autotune cell's availability key is ``kernels_available`` (the
    reference's ``pallas_available`` is the same fact);
  * ``roofline`` has no counterpart yet (it reads the reference's dry-run
    records).

``main(argv, device="cpu")`` runs every pass on the CPU (the tests); the
default device is the card, and without one ``main`` raises.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import os
import sys
import time
import traceback

from ..core.envvars import get_env
from ..device import resolve_device
from . import (autotune, bridge_validation, fig7_tile, fig8_buffer,
               fig9_order, fig10_parallelism, fig11_shape, fig12_arraysize,
               fig13_futureproof, flexion_bench, roofline, service_bench,
               table3_area)
from ._compare import derived_equal, public_derived
from .common import MODES, ga_budget

BENCHES = {
    "table3": (table3_area, "fullflex_overhead_pct"),
    "fig7": (fig7_tile, "fullflex1000_speedup"),
    "fig8": (fig8_buffer, "speedup_1k_to_64k"),
    "fig9": (fig9_order, "fullflex0100_speedup"),
    "fig10": (fig10_parallelism, "fullflex_speedup_16x64"),
    "fig11": (fig11_shape, "fullflex_speedup"),
    "fig12": (fig12_arraysize, "speedup_256_to_1024"),
    "fig13": (fig13_futureproof, "fullflex1111_geomean_future"),
    "flexion": (flexion_bench, "partflex1000_hf_T"),
    "bridge": (bridge_validation, "long_decode_speedup"),
    "roofline": (roofline, "cells_ok"),
    "service": (service_bench, "_speedup_vs_sequential"),
    "autotune": (autotune, "parity_ok"),
}

BENCH_SCHEMA = "repro-bench-mapper/v7"

# benches whose derived metrics are pure functions of the MSE engines or the
# (seed-deterministic) flexion estimators: the golden-parity gate covers
# only these (bridge reads external records, table3 never touches the
# mapper, and autotune measures wall-clock so it runs ONCE after the engine
# passes).  "service" qualifies: its gated keys (client/query counts,
# parity/cache flags, unique row count) are load- and placement-independent
# by the service's bit-parity contract.
PARITY_BENCHES = {"fig7", "fig8", "fig9", "fig10", "fig11", "fig12",
                  "fig13", "flexion", "service"}

# sidecars that hold in-memory objects for a caller's further checks
# (flexion reports, autotune runners, bridge_validation's lowered configs):
# never written to a file
_OBJECT_SIDECARS = ("_reports", "_runs", "_lowered")


def _pass_args(label: str):
    """(MSE path, device pool) of a pass label: ``serial``, ``batched``,
    ``campaign`` or ``campaign-d<spec>``."""
    if label.startswith("campaign-d"):
        return "campaign", label[len("campaign-d"):]
    if label in ("serial", "batched", "campaign"):
        return label, None
    raise ValueError(f"unknown pass {label!r}; expected serial, batched, "
                     f"campaign or campaign-d<devices>")


def _warm_engine(label: str, mode: str, device) -> None:
    """Bring up what a pass runs outside the timed region — us_per_call
    reports steady-state per-figure cost, not first-use set-up.

    Warms the pass's engine (the serial evaluator, in both hard-partition
    variants, or ``warmup_engine`` on every pool device of a batched or
    campaign pass), the engine-independent fixed-config objective, and the
    flexion estimators at the mode's sample budget.  Errors propagate: a
    pass whose warm-up fails would otherwise time a device it never
    checked."""
    from ..core import (Layer, PARTFLEX, compute_flexion,
                        evaluate_fixed_genome, make_variant, search,
                        search_fixed_config, search_fixed_configs)
    from ..core.device_pool import pool_for
    from ..core.engine import ROW_BUCKET, warmup_engine
    from ..core.flexion_batched import clear_flexion_reference_cache

    path, devices = _pass_args(label)
    cfg = ga_budget(mode, path, devices=devices)
    tiny = Layer("warmup", (4, 4, 4, 4, 1, 1))
    compute_flexion(make_variant("1111", PARTFLEX), tiny,
                    mc_samples=flexion_bench.MC_BY_MODE[mode], device=device,
                    devices=devices)
    clear_flexion_reference_cache()
    if path == "serial":
        scfg = dataclasses.replace(cfg, generations=2)
        search(tiny, make_variant("1111"), scfg, device)
        search(tiny, make_variant("1111", PARTFLEX), scfg, device)
    else:
        warmup_engine(cfg, device=device)    # every pool device
    wcfg = dataclasses.replace(cfg, generations=2)
    genome, _ = search_fixed_config([tiny], make_variant("1111"), wcfg,
                                    device=device)
    if path == "campaign":
        # the model-stacked fixed-config program at fig13's model count
        search_fixed_configs(
            [([tiny], make_variant("1111"))] * len(fig13_futureproof.MODELS),
            wcfg, device=device)
        pool = pool_for(cfg, device)
        if pool is not None and len(pool) > 1:
            evaluate_fixed_genome([tiny] * (ROW_BUCKET * len(pool)),
                                  make_variant("1111"), genome,
                                  device=device, devices=devices)


def _call(mod, **kw) -> dict:
    """``mod.run`` with the arguments its signature takes."""
    params = inspect.signature(mod.run).parameters
    return mod.run(**{k: v for k, v in kw.items() if k in params})


def _run_once(names, **kw):
    """Run the selected benches once; returns (csv_rows, results, failed)."""
    csv_rows = []
    results = {}
    failed = 0
    for name in names:
        mod, headline = BENCHES[name]
        t0 = time.time()
        try:
            derived = _call(mod, **kw)
            results[name] = derived
            dt_us = (time.time() - t0) * 1e6
            csv_rows.append((name, dt_us, derived.get(headline)))
        except Exception as e:  # noqa: BLE001 - counted: the run exits 1
            failed += 1
            traceback.print_exc()
            csv_rows.append((name, (time.time() - t0) * 1e6,
                             f"ERROR:{type(e).__name__}"))
    return csv_rows, results, failed


def _speedup_row(rows_a, rows_b):
    speedup = {}
    total_a = total_b = 0.0
    for (name, us_a, _), (_, us_b, _) in zip(rows_a, rows_b):
        speedup[name] = round(us_a / max(us_b, 1.0), 2)
        total_a += us_a
        total_b += us_b
    speedup["total"] = round(total_a / max(total_b, 1.0), 2)
    return speedup


def _devices_available(device) -> int:
    from ..dist.pool import DevicePool
    return len(DevicePool.from_spec("all", device))


def _bench_json(engine_rows, engine_results, mode, devices=None,
                device=None):
    """BENCH artifact (schema v7): per-pass per-bench us_per_call + derived
    metrics (+ phase timings), pairwise speedups between passes, and — when
    a ``--devices`` pass ran — a ``device_scaling`` block recording the
    pool size and the campaign -> pooled-campaign speedup."""
    doc = {
        "schema": BENCH_SCHEMA,
        "bench_mode": mode,
        "created_unix": int(time.time()),
        "warmup": True,   # each pass is warmed before its timed loop
        "engines": {},
    }
    for engine, rows in engine_rows.items():
        entry = {}
        for name, us, _ in rows:
            derived = engine_results[engine].get(name, {})
            cell = {"us_per_call": round(us, 1),
                    "derived": public_derived(derived)}
            if "_phases" in derived:
                cell["phases"] = {k: round(v * 1e6, 1)   # us, like us_per_call
                                  for k, v in derived["_phases"].items()}
            # service load metrics ride along as cell columns — real data
            # in the artifact, but outside "derived" so the diff gate never
            # compares machine-dependent throughput
            if "_speedup_vs_sequential" in derived:
                cell["speedup_vs_sequential"] = \
                    derived["_speedup_vs_sequential"]
            if "_throughput_qps" in derived:
                cell["throughput_qps"] = derived["_throughput_qps"]
            # autotune's machine-dependent raw numbers (correlations,
            # tuned/default timings) ride along outside "derived"
            if "_rank_corr_matmul" in derived:
                cell["measured"] = {k[1:]: v for k, v in derived.items()
                                    if k.startswith("_")
                                    and k not in _OBJECT_SIDECARS}
            entry[name] = cell
        doc["engines"][engine] = entry
    for a, b, key in (("serial", "batched", "speedup_serial_over_batched"),
                      ("batched", "campaign",
                       "speedup_batched_over_campaign"),
                      ("serial", "campaign", "speedup_serial_over_campaign")):
        if {a, b} <= set(engine_rows):
            doc[key] = _speedup_row(engine_rows[a], engine_rows[b])
    if devices:
        label = f"campaign-d{devices}"
        try:
            requested = int(devices)
        except ValueError:
            requested = devices          # "all" / explicit index list
        scaling = {"pass": label, "devices_requested": requested,
                   "devices_available": _devices_available(device)}
        if {label, "campaign"} <= set(engine_rows):
            scaling["speedup_campaign_over_devices"] = _speedup_row(
                engine_rows["campaign"], engine_rows[label])
        if {label, "serial"} <= set(engine_rows):
            scaling["speedup_serial_over_devices"] = _speedup_row(
                engine_rows["serial"], engine_rows[label])
        doc["device_scaling"] = scaling
    return doc


def _file_results(results: dict) -> dict:
    return {name: {k: v for k, v in derived.items()
                   if k not in _OBJECT_SIDECARS}
            for name, derived in results.items()}


def main(argv=None, device=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    device = resolve_device(device)
    json_path = None
    mode = "default"
    engines = ["batched"]
    campaign = False
    autotune_pass = False
    devices = None
    service_clients = None
    rest = []
    it = iter(argv)
    for a in it:
        if a in ("--json", "--mode", "--engines", "--devices", "--service"):
            value = next(it, None)
            if value is None:
                print(f"error: {a} expects a value", file=sys.stderr)
                return 2
            if a == "--json":
                json_path = value
            elif a == "--mode":
                if value not in MODES:
                    print(f"error: --mode expects one of {MODES}, got "
                          f"{value!r}", file=sys.stderr)
                    return 2
                mode = value
            elif a == "--service":
                # N concurrent DSE-service clients; adds the "service"
                # bench (concurrent clients vs sequential campaigns)
                try:
                    service_clients = int(value)
                    if service_clients < 1:
                        raise ValueError(value)
                except ValueError:
                    print(f"error: --service expects a positive client "
                          f"count, got {value!r}", file=sys.stderr)
                    return 2
            elif a == "--devices":
                # same grammar as REPRO_DEVICES: count | "all" | i,j indices
                from ..dist.pool import parse_device_spec
                try:
                    if parse_device_spec(value) is None:
                        raise ValueError("empty device spec")
                except ValueError as e:
                    print(f"error: --devices {value!r}: {e}",
                          file=sys.stderr)
                    return 2
                devices = value.strip()
            else:
                engines = [e.strip() for e in value.split(",") if e.strip()]
        elif a == "--campaign":
            campaign = True
        elif a == "--autotune":
            autotune_pass = True
        else:
            rest.append(a)
    if get_env("REPRO_DEVICES"):
        # every layer under a pass falls back to REPRO_DEVICES when its
        # pool is None, so it would pool the serial/batched/campaign passes
        print("error: REPRO_DEVICES is set; the writer takes its device "
              "pool from --devices only (unset the variable)",
              file=sys.stderr)
        return 2
    try:
        if campaign and "campaign" not in engines:
            engines.append("campaign")
        if devices is not None and f"campaign-d{devices}" not in engines:
            engines.append(f"campaign-d{devices}")
        if not engines:
            raise ValueError("--engines names no pass")
        for label in engines:
            _pass_args(label)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # autotune is opt-in (--autotune or named explicitly): it measures real
    # kernel wall-clock, so a plain run stays model-only
    names = ([a for a in rest if a in BENCHES]
             or [n for n in BENCHES if n != "autotune"])
    if "autotune" in names:
        autotune_pass = True
        names.remove("autotune")
    if service_clients is not None and "service" not in names:
        names.append("service")

    engine_rows = {}
    engine_results = {}
    failed = 0
    for engine in engines:
        path, pool = _pass_args(engine)
        _warm_engine(engine, mode, device)
        rows, results, nfail = _run_once(
            names, mode=mode, path=path, devices=pool, device=device,
            clients=service_clients or 4)
        engine_rows[engine] = rows
        engine_results[engine] = results
        failed += nfail

    # measured-runtime autotune pass: runs ONCE under its own label after
    # the engine loop (wall-clock objective — engine choice is irrelevant),
    # so the engines list, parity gate and results/bench_results.json are
    # untouched
    if autotune_pass:
        rows, results, nfail = _run_once(["autotune"], mode=mode,
                                         device=device)
        engine_rows["autotune"] = rows
        engine_results["autotune"] = results
        failed += nfail

    # golden-parity gate: every pass must derive identical metrics on the
    # engine-driven benches.  A mismatch is a real engine bug (the batched/
    # campaign paths promise bit-identical results), so it fails the run.
    base = engines[0]
    for engine in engines[1:]:
        for name in names:
            if name not in PARITY_BENCHES:
                continue
            if (name not in engine_results[base]
                    or name not in engine_results[engine]):
                continue   # the pass crashed — already counted
            da = public_derived(engine_results[base][name])
            db = public_derived(engine_results[engine][name])
            if not derived_equal(da, db):
                failed += 1
                print(f"PARITY MISMATCH {name}: [{base}] {da} != "
                      f"[{engine}] {db}", file=sys.stderr)

    os.makedirs("results", exist_ok=True)
    with open("results/bench_results.json", "w") as f:
        json.dump(_file_results(engine_results[engines[-1]]), f, indent=2,
                  default=str)
    if json_path:
        with open(json_path, "w") as f:
            json.dump(_bench_json(engine_rows, engine_results, mode,
                                  devices=devices, device=device), f,
                      indent=2, default=str)
        print(f"\nwrote {json_path}")

    for engine, erows in engine_rows.items():
        tag = f"[{engine}] " if len(engine_rows) > 1 else ""
        print(f"\n{tag}name,us_per_call,derived")
        for name, us, derived in erows:
            print(f"{name},{us:.0f},{derived}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
