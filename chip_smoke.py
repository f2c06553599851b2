#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Builds the CUDA kernels from this checkout, holds each against its plain
PyTorch version, then drives the port's main path as a user would call it:

  1. kernel — the Hopper ``tiled_matmul`` against ``tiled_matmul_plain`` on
     the kernel test sweep (4 shapes x 3 orders x {f32, bf16, int8}) and the
     int8 overflow case;
  2. search — ``search_model`` of BERT-base (d=768, d_ff=3072, 12 heads,
     seq 512) at the paper's 100x100 GA budget on InFlex-0000 and
     FullFlex-1111, batched engine on the card; checked bit-identical to
     the serial engine on the card and to the port on the CPU;
  3. bridge — every searched BERT mapping lowered onto the kernel, legal,
     timed, and checked against the plain version and the oracle;
  4. tune — measured-objective ``tune_kernel`` and the predicted-vs-measured
     rank correlation on BERT ``ffn_up`` at float32.

Phases 2-4 are the main path: the kernel launch counts are zeroed before it
and read after it.  Any failed check ends the run with a non-zero exit.
The last lines are the kernel table as JSON, the card's name and power
limit, and ``{"ok": true, "device": ...}``.

    python3 chip_smoke.py        # from the root of a checkout, one card
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SWEEP = [(128, 128, 128, 64, 64, 64), (256, 192, 64, 64, 64, 32),
         (64, 64, 256, 32, 32, 128), (128, 256, 128, 128, 128, 128)]
ORDERS = ("out", "a", "b")
# (rtol, atol) of kernel vs plain version, per operand dtype
TOLS = {"float32": (2e-5, 1.6e-4), "bfloat16": (2e-2, 0.16), "int8": (0, 0)}
# H100 SXM peaks (NVIDIA data sheet, dense): device memory bytes/s, and
# operations/s per operand dtype (float32 runs on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def log(*parts) -> None:
    print(*parts, flush=True)


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def bench_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(m: int, n: int, k: int, dtype: str):
    """Least time the card could take for one (M,K)@(K,N) product: each
    input read once and the output written once, or 2*M*N*K operations at
    the dtype's peak, whichever is longer."""
    item = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    t_bytes = (m * k + k * n + m * n) * item / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * n * k / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(x, y):
    """One PyTorch call computing the same product, or None: float
    operands go to ``torch.matmul``; no single call reproduces the int8
    kernel's saturating (or wrapping) output."""
    import torch
    if x.dtype == torch.int8:
        return None
    return lambda: torch.matmul(x, y)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_kernel(torch, tm):
    rng = np.random.default_rng(0)
    worst = 0.0
    for m, n, k, bm, bn, bk in SWEEP:
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            if dt == torch.int8:
                xs = rng.integers(-1, 2, (m, k)), rng.integers(-1, 2, (k, n))
            else:
                xs = rng.normal(size=(m, k)), rng.normal(size=(k, n))
            x, y = (torch.as_tensor(a.astype(np.float32)).to("cuda").to(dt)
                    for a in xs)
            for order in ORDERS:
                got = tm.tiled_matmul(x, y, bm=bm, bn=bn, bk=bk, order=order)
                want = tm.tiled_matmul_plain(x, y, bm=bm, bn=bn, bk=bk,
                                             order=order)
                torch.cuda.synchronize()
                rtol, atol = TOLS[dtype_name(dt)]
                check(torch.allclose(got.float(), want.float(), rtol=rtol,
                                     atol=atol),
                      f"kernel vs plain {(m, n, k)} {order} {dt}")
                worst = max(worst, max_err(got, want))
    # int8 overflow: 256 ones per dot; "out" saturates once, "a"/"b" add two
    # saturated 128-wide partials in int8 and wrap
    x = torch.ones((8, 256), dtype=torch.int8, device="cuda")
    y = torch.ones((256, 8), dtype=torch.int8, device="cuda")
    for order, want in (("out", 127), ("a", -2), ("b", -2)):
        got = tm.tiled_matmul(x, y, bm=8, bn=8, bk=128, order=order)
        plain = tm.tiled_matmul_plain(x, y, bm=8, bn=8, bk=128, order=order)
        check(bool((got == want).all()) and bool((plain == want).all()),
              f"int8 overflow {order}: want {want}")
    log(f"[kernel] sweep {len(SWEEP)} shapes x 3 orders x 3 dtypes + int8 "
        f"overflow: kernel == plain (max abs err {worst:.3g})")
    return worst


def phase_search(core):
    """BERT at the paper's budget: batched on the card, checked against the
    serial engine on the card and the batched port on the CPU."""
    layers = core.get_model("bert")
    specs = (core.inflex_baseline(), core.make_variant("1111"))
    cfg = core.GAConfig()
    core.warmup_engine(cfg)            # first use of each op, untimed
    results, walls = {}, {}
    for spec in specs:
        t0 = time.perf_counter()
        results[spec.name] = core.search_model(layers, spec, cfg)
        walls[spec.name] = time.perf_counter() - t0
    return layers, specs, results, walls


def same_rows(a, b, exact: bool) -> bool:
    for ra, rb in zip(a.per_layer, b.per_layer):
        if ra.mapping != rb.mapping:
            return False
        for f in ("runtime", "energy", "edp", "util", "dram_elems"):
            va, vb = getattr(ra, f), getattr(rb, f)
            if (va != vb) if exact else abs(va - vb) > 1e-6 * abs(vb):
                return False
        if exact and (ra.history != rb.history or ra.feasible != rb.feasible):
            return False
    return True


def check_search(core, layers, specs, results, walls):
    import dataclasses
    for spec in specs:
        t0 = time.perf_counter()
        serial = core.search_model(
            layers, spec, dataclasses.replace(core.GAConfig(),
                                              engine="serial"))
        t_serial = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = core.search_model(layers, spec, core.GAConfig(),
                                   device="cpu")
        t_cpu = time.perf_counter() - t0
        got = results[spec.name]
        check(same_rows(got, serial, exact=True),
              f"{spec.name}: batched == serial on the card")
        check(same_rows(got, on_cpu, exact=False),
              f"{spec.name}: card == CPU (genomes, rel 1e-6)")
        log(f"[search] {spec.name}: model runtime {got.runtime!r} cycles; "
            f"wall s: batched(card) {walls[spec.name]:.3f}, serial(card) "
            f"{t_serial:.3f}, batched(cpu) {t_cpu:.3f}; serial and CPU "
            f"rows equal")
    base, flex = (results[s.name].runtime for s in specs)
    log(f"[search] FullFlex1111 over InFlex-0000 speedup {base / flex!r}")


def bert_bridge(core, kb, layers, specs, results, runner):
    """Lower, time and oracle-check every searched BERT mapping (the main
    path's kernel launches).  Returns the configs for later checks."""
    rows = []
    for spec in specs:
        for layer, res in zip(layers, results[spec.name].per_layer):
            m, kred, n = layer.dims[0], layer.dims[1], layer.dims[2]
            wl = kb.matmul_workload(m, n, kred)
            cfg = kb.lower_mapping(wl, res.mapping)
            check(kb.config_legal(wl, cfg), f"{layer.name} config legal")
            seconds = runner.measure(wl, cfg)
            ok, err = kb.parity_check(wl, cfg, runner.inputs_for(wl))
            rows.append((spec.name, layer.name, wl, cfg, seconds, ok, err))
    return rows


def check_bridge(torch, kernels, tm, rows, runner):
    wrap_only = 0
    worst = 0.0
    for spec_name, name, wl, cfg, seconds, ok, err in rows:
        dt = kernels.dtype_for_bits(cfg.bits)
        x, y = (kernels.cast(a, dt) for a in runner.inputs_for(wl))
        bm, bn, bk = cfg.block
        got = tm.tiled_matmul(x, y, bm=bm, bn=bn, bk=bk, order=cfg.order)
        plain = tm.tiled_matmul_plain(x, y, bm=bm, bn=bn, bk=bk,
                                      order=cfg.order)
        rtol, atol = TOLS[dtype_name(x.dtype)]
        check(torch.allclose(got.float(), plain.float(), rtol=rtol,
                             atol=atol), f"{name}: kernel == plain")
        worst = max(worst, max_err(got, plain))
        if not ok:
            # the oracle casts once after all of K; "a"/"b" cast and add
            # per K-block (int8 wraps): a miss the plain version shares is
            # the reference's own semantics
            check(cfg.order in ("a", "b") and x.dtype == torch.int8,
                  f"{name}: parity miss outside the int8 a/b wrap")
            wrap_only += 1
        plain_ms = bench_ms(lambda: tm.tiled_matmul_plain(
            x, y, bm=bm, bn=bn, bk=bk, order=cfg.order), reps=3, warmup=1)
        lib = library_call(x, y)
        lib_ms = bench_ms(lib) if lib else None
        m, n, k = wl.shape
        b_ms, b_by = bound_ms(m, n, k, dtype_name(x.dtype))
        log(f"[bridge] {spec_name} {name} (M,N,K)={wl.shape} "
            f"{dtype_name(x.dtype)} blocks={cfg.block} order={cfg.order}: "
            f"kernel {seconds * 1e3:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {'null' if lib_ms is None else f'{lib_ms:.4f} ms'}, "
            f"bound {b_ms:.4f} ms ({b_by}); parity vs oracle "
            f"{'ok' if ok else 'MISS'} (max abs err {err:g})")
    log(f"[bridge] {len(rows)} configs: kernel == plain on all; "
        f"{wrap_only} oracle misses from the int8 a/b wrap only")
    return worst


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch import core
        from repro_torch.core import kernel_bridge as kb
        from repro_torch import kernels
        from repro_torch.kernels import _build
        from repro_torch.kernels import tiled_matmul as tm
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] csrc/*.cu for sm_90a in {time.perf_counter() - t0:.1f} s")
    ptxas = _build.build_log("tiled_matmul").splitlines()
    regs = sorted({line.split("Used ")[1].split(" registers")[0]
                   for line in ptxas if "registers" in line})
    spills = sorted({line.strip() for line in ptxas if "spill" in line})
    log(f"[build] tiled_matmul instantiations use {regs} registers; "
        f"{spills}")

    worst = phase_kernel(torch, tm)

    # ---- main path: counts zeroed before, read after ---------------------
    tm.tiled_matmul.launches = 0
    layers, specs, results, walls = phase_search(core)
    runner = kb.MeasuredRunner(repeats=3, warmup=1)
    rows = bert_bridge(core, kb, layers, specs, results, runner)
    wl_up = kb.matmul_workload(3072, 512, 768)            # BERT ffn_up
    spec_up = core.make_variant("1100", fixed_bits=32)
    tune_runner = kb.MeasuredRunner(repeats=2, warmup=1)
    tuned = kb.tune_kernel(wl_up, spec_up, runner=tune_runner)
    study = kb.rank_correlation_study(wl_up, spec_up, n_samples=16,
                                      runner=tune_runner)
    launches = tm.tiled_matmul.launches
    # ----------------------------------------------------------------------

    check(launches > 0, "main path launched tiled_matmul")
    log(f"[main path] tiled_matmul launches: {launches}")
    check_search(core, layers, specs, results, walls)
    worst = max(worst, check_bridge(torch, kernels, tm, rows, runner))

    check(tuned.objective == "measured", "tune objective is measured")
    check(tuned.measured_configs > 0, "tune measured configs")
    check(kb.config_legal(wl_up, tuned.config), "tuned config legal")
    check(study["all_legal"], "rank study configs legal")
    x, y = tune_runner.inputs_for(wl_up)
    bm, bn, bk = tuned.config.block
    got = tm.tiled_matmul(x, y, bm=bm, bn=bn, bk=bk, order=tuned.config.order)
    plain = tm.tiled_matmul_plain(x, y, bm=bm, bn=bn, bk=bk,
                                  order=tuned.config.order)
    check(torch.allclose(got, plain, rtol=TOLS["float32"][0],
                         atol=TOLS["float32"][1]), "tuned: kernel == plain")
    worst = max(worst, max_err(got, plain))
    ms = bench_ms(lambda: tm.tiled_matmul(x, y, bm=bm, bn=bn, bk=bk,
                                          order=tuned.config.order))
    plain_ms = bench_ms(lambda: tm.tiled_matmul_plain(
        x, y, bm=bm, bn=bn, bk=bk, order=tuned.config.order), reps=3)
    lib_ms = bench_ms(library_call(x, y))
    b_ms, b_by = bound_ms(3072, 512, 768, "float32")
    log(f"[tune] ffn_up f32 on {spec_up.name}: tuned blocks "
        f"{tuned.config.block} order {tuned.config.order}, "
        f"{tuned.measured_configs} configs timed, best "
        f"{tuned.best_cost * 1e3:.4f} ms; predicted {tuned.predicted!r} "
        f"cycles; spearman over {study['n_configs']} configs "
        f"{study['spearman']!r}")
    log(f"[tune] tuned config: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.matmul {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "tiled_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tiled_matmul.cu",
        "replaces": "src/repro/kernels/tiled_matmul.py:54",
        "launches": launches, "max_abs_err": worst, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms}]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
