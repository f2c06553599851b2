#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Builds the CUDA kernels from this checkout, holds each against its plain
PyTorch version, then drives the port's two main paths as a user would
call them:

  1. kernel — each Hopper kernel against its plain version: tiled_matmul on
     the kernel test sweep plus the odd blocks the bridge lowers (11 shapes
     x 3 orders x {f32, bf16, int8}) and the int8 overflow case;
     flash_attention at f32 and bf16, causal and full, on the attention
     sweep plus an odd and a size-1 block and a shape for each branch of
     its launch plan; mamba_scan on the scan sweep
     plus a shape for each branch of its launch plan; then the float32
     tiled_matmul at BERT ``ffn_up`` width on fixed configs, timed against
     its plain version, ``torch.matmul`` and its bound, with its launch
     plan, and the bfloat16 and int8 tiled_matmul (tensor cores) the same
     way on five fixed blocks, full-range operands, beside
     ``torch.matmul`` and ``torch._int_mm``; then mamba_scan at
     falcon-mamba-7b width (batch 1, seq 4096, d_inner 8192, d_state 16)
     on fixed (chunk, d_block), timed against its bound and the SFU's
     exponential rate, with its launch plan (``[scan]``); then
     flash_attention at BERT-base width (12 heads, seq 512, head_dim 64,
     causal, float32) on fixed (bq, bkv): kernel ms beside the bound and
     the mapping's block-granular work, the launch plan and the max error
     against the plain version (``[attention]``);
  2. search — ``search_model`` of BERT-base (d=768, d_ff=3072, 12 heads,
     seq 512) at the paper's 100x100 GA budget on InFlex-0000 and
     FullFlex-1111, batched engine on the card; checked bit-identical to
     the serial engine on the card and to the port on the CPU;
  3. bridge — every searched BERT mapping lowered onto the matmul kernel,
     legal, timed, and checked against the plain version and the oracle;
  4. autotune — the port's autotune pass (predicted-vs-measured rank
     correlation + measured GA tuning) at full width on
     ``make_variant("1100", fixed_bits=32)``: BERT ``ffn_up`` matmul
     (3072, 512, 768), BERT-base attention (12 heads, seq 512, head_dim 64)
     and the falcon-mamba-7b scan (batch 1, seq 4096, d_inner 8192,
     d_state 16); every timed and tuned config is then checked against the
     plain version and the oracle;
  5. dse — the port's fig7, fig11, fig13 and flexion benches in fast mode
     on the card (serial, batched and the pipelined campaign MSE paths),
     held to the anchors pinned in BENCH_mapper.json at rel 1e-6, the three
     paths equal bit for bit; then fig7, fig11 and fig13 on the campaign
     path over device pools (``devices=4``, clamped to the cards present,
     and ``(0, 0)``, a depth-2 queue on card 0: the reference's
     campaign-d4 pass), each equal to the plain campaign bit for bit; the
     flexion anchors on the float64 numpy path, with the float32 torch
     backend's fractions printed beside them;
  6. pipeline — fig13's sweep rows (the 32 classes and PartFlex-1111 on
     all 7 models, 3648 rows) through ``run_batched_ga`` with the pipeline
     off and on: wall times, results equal;
  7. service — the port's DSE service bench, 4 concurrent clients on the
     card: parity with sequential campaigns, cache-served repeats and the
     row counts held to BENCH_mapper.json, times written down;
  8. bridge validation — the port's bridge_validation bench on the card:
     genomes sampled on ``make_variant("11001")`` for a 32x32x32 matmul,
     (1, 32, 16) attention and a (1, 16, 8, 4) scan, lowered, checked legal
     and run on all three kernels against the oracle, each lowered config
     also held against the kernel's plain version; the legality mirror
     against ``raw_tile_feasibility`` on the card;
  9. bench — the port's BENCH writer (``repro_torch.bench.run``) in fast
     mode over every bench it has, a batched pass and a pass over
     ``--devices 0,0`` (a depth-2 queue on card 0), the service bench with
     4 clients and the autotune pass at the reference's own shapes, written
     to ``results/BENCH_torch.json``: exit 0 (its golden-parity gate
     across passes), fig7 / fig11 / fig13 / flexion / service equal to
     BENCH_mapper.json's batched cells and the other figures to
     anchors_fast.json at rel 1e-6, the autotune cell's parity, legality
     and availability gates; its three Spearman signs printed beside the
     TPU's.

Phase 5 also runs fig8, fig9, fig10 and fig12 in fast mode on all three MSE
paths, held to the reference's fast-mode values pinned in
``src/repro_torch/bench/anchors_fast.json`` (floats at rel 1e-6, booleans
equal), the paths equal bit for bit, with fig8's W-F(T) means under the
card's float32 flexion beside a float64 numpy run; and table3 once.

Then the wrapper's host time a call at the tuned attention blocks, beside
the kernel's device time from torch.profiler (``[attention host floor]``).

Phases 2-3 (search -> bridge), phase 4 (autotune), phase 8 (bridge
validation) and phase 9 (bench) are the main paths: the kernel launch
counts are zeroed before each and read after it.  Any failed check
ends the run with a non-zero exit.  The last lines are the kernel table as
JSON, the card's name and power limit, and ``{"ok": true, "device": ...}``.

    python3 chip_smoke.py        # from the root of a checkout, one card

``--attention-only`` builds the kernels and runs the ``[attention]`` phase
alone, at ATTN_FIXED and at the blocks ``--attention-blocks`` adds
(``16x128,256x2``): copied into another checkout, it times that checkout's
kernel on the same configs (a kernel without a launch plan prints none).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# tests/test_kernels.py's matmul sweep, then blocks the bridge lowers (bm = 1,
# bn = 2, bk = 2, odd widths), a 128x256 tile (float32 accumulator in shared
# memory) and bk not a multiple of 4, as in tests/test_torch_cuda.py
SWEEP = [(128, 128, 128, 64, 64, 64), (256, 192, 64, 64, 64, 32),
         (64, 64, 256, 32, 32, 128), (128, 256, 128, 128, 128, 128),
         (192, 512, 48, 96, 4, 16), (192, 512, 48, 64, 2, 16),
         (256, 512, 48, 128, 256, 12), (192, 512, 48, 1, 512, 2),
         (192, 256, 384, 96, 128, 192), (192, 512, 48, 64, 32, 6),
         (96, 80, 45, 3, 5, 9)]
# float32 ffn_up at fixed blocks: a thin tile, a 32x128 tile, 128x128 tiles
# with one operand buffer (bk 96) and two (bk 32), and the autotune pass's
# max-block default (order "a")
F32_FIXED = [((96, 4, 16), "out"), ((32, 128, 32), "out"),
             ((128, 128, 96), "out"), ((128, 128, 32), "out"),
             ((96, 128, 192), "a")]
# bfloat16 / int8 ffn_up at fixed blocks: the InFlex block, the FullFlex
# ffn_up, qkv_proj and out_proj blocks the bridge lowers, and a tile that is
# a whole number of tensor-core fragments
LOWBIT_FIXED = [((64, 2, 16), "a"), ((128, 256, 12), "out"),
                ((96, 256, 48), "out"), ((64, 64, 384), "b"),
                ((128, 128, 64), "out")]
ORDERS = ("out", "a", "b")
# (rtol, atol) of kernel vs plain version, per operand dtype
TOLS = {"float32": (2e-5, 1.6e-4), "bfloat16": (2e-2, 0.16), "int8": (0, 0)}
# tests/test_kernels.py's attention sweep (h, sq, skv, d, bq, bkv), plus an
# odd block and size-1 blocks, then one shape for each branch of
# attention_plan (as in tests/test_torch_cuda.py): bkv = 1 and 2, bq = 1,
# a q-block split over 8 CTAs, double-buffered runs of thin blocks, d = 16
# and 128, bkv = 3, Sq != Skv both ways, a block in two chunks, two column
# passes (d = 256, 12), single values (d = 7), K and V read straight from
# device memory (two rows a CTA at 128-key blocks) and the full-width thin
# config; (rtol, atol) per dtype as in that test
ATTN_SWEEP = [(2, 128, 128, 64, 64, 64), (4, 64, 256, 32, 32, 64),
              (1, 256, 256, 128, 128, 128), (2, 96, 96, 32, 3, 96),
              (2, 64, 64, 16, 1, 1),
              (2, 64, 64, 64, 16, 1), (2, 64, 64, 32, 32, 2),
              (2, 64, 64, 64, 1, 32), (2, 256, 256, 64, 128, 32),
              (2, 128, 128, 64, 64, 4), (2, 64, 64, 16, 16, 32),
              (2, 128, 128, 128, 32, 64), (2, 48, 48, 64, 48, 3),
              (2, 64, 128, 32, 16, 32), (2, 128, 64, 32, 32, 16),
              (1, 32, 2048, 16, 16, 1024), (1, 32, 32, 256, 16, 16),
              (2, 32, 48, 12, 8, 16), (1, 16, 16, 7, 4, 4),
              (2, 64, 256, 64, 2, 128), (12, 512, 512, 64, 256, 2)]
ATTN_TOLS = {"float32": (2e-5, 1.6e-4), "bfloat16": (3e-2, 0.24)}
# tests/test_kernels.py's scan sweep (B, L, D, N, chunk, d_block), plus a
# d-block wider than one kernel block's threads, then one shape for each
# branch of scan_plan (as in tests/test_torch_cuda.py): 1, 2, 8 and 16
# states a thread, N = 1, 5 and 128, splits over 2, 5 and 8 CTAs with passes,
# B = 3 at chunk = d_block = 1, staging by cp.async and not ahead, and a
# long chain at a narrow D
SCAN_SWEEP = [(1, 32, 16, 8, 8, 8), (2, 64, 32, 16, 16, 16),
              (2, 128, 64, 8, 32, 32), (1, 64, 192, 16, 4, 192),
              (1, 16, 4, 16, 16, 2), (1, 16, 2, 16, 16, 1),
              (1, 16, 4, 16, 16, 4),
              (1, 8, 64, 64, 4, 64), (1, 8, 64, 128, 4, 64),
              (1, 8, 16, 1, 4, 16), (1, 20, 40, 5, 20, 40),
              (1, 8, 70, 33, 2, 70), (1, 16, 1024, 16, 4, 1024),
              (3, 12, 24, 16, 1, 1), (1, 256, 512, 16, 128, 512),
              (2, 64, 8, 16, 64, 1), (1, 8, 2, 125, 1, 1),
              (1, 2048, 32, 16, 64, 16)]
SCAN_TOLS = (2e-4, 2e-4)
# the scan at falcon-mamba-7b width on fixed (chunk, d_block), so that kernel
# changes are compared at configs that do not move when the tuner's choice
# does: the first kernel's tuned block, narrow d-blocks, a split over 8 CTAs in
# one pass, splits with passes, and one channel a grid unit
SCAN_FIXED = [(16, 8), (16, 4), (4, 4), (16, 1), (256, 512), (64, 2048),
              (8, 4096), (1024, 1)]
# attention at BERT-base width on fixed (bq, bkv), so that kernel changes
# are compared at configs that do not move when the tuner's choice does:
# the block the tuner has picked, the max-block default, configs of the rank
# study, the widest legal bq, and the thin branches (one row a q-block, one
# key a block)
ATTN_FIXED = [(16, 128), (256, 256), (128, 128), (256, 64), (256, 16),
              (128, 8), (256, 2), (512, 128), (1, 256), (64, 1)]
# the SFU's ex2 rate an SM a clock (H100: 16), for the exponential figure
SFU_EX2_PER_CLOCK = 16
# the autotune pass at full width: BERT ffn_up, BERT-base attention and
# falcon-mamba-7b (src/repro/configs/falcon_mamba_7b.py: d_model 4096,
# expand 2 -> d_inner 8192, ssm_state 16) at batch 1, seq 4096
FULL_SHAPES = {"matmul": (3072, 512, 768), "attention": (12, 512, 64),
               "mamba": (1, 4096, 8192, 16)}
KERNELS = ("tiled_matmul", "flash_attention", "mamba_scan")
KIND_KERNEL = {"matmul": "tiled_matmul", "attention": "flash_attention",
               "mamba": "mamba_scan"}
REPLACES = {"tiled_matmul": "src/repro/kernels/tiled_matmul.py:54",
            "flash_attention": "src/repro/kernels/flash_attention.py:64",
            "mamba_scan": "src/repro/kernels/mamba_scan.py:58"}
# the BENCH_mapper.json anchors each port bench must reproduce
ANCHORS = {
    "fig7": ("fullflex1000_speedup", "partflex1000_speedup", "ordering_ok"),
    "fig11": ("fullflex_speedup", "partflexB_close_to_full"),
    "fig13": ("fullflex1111_geomean_future", "fullflex11111_geomean_future",
              "beats_inflex_everywhere", "fullflex1111_hf"),
    "flexion": ("campaign_matches_serial", "all_in_unit_interval",
                "partflex1000_hf_T", "fullflex1111_hf"),
}
ANCHOR_RTOL = 1e-6
# the service bench's deterministic keys, held equal to BENCH_mapper.json
SERVICE_KEYS = ("clients", "queries_per_client", "parity_ok",
                "repeat_cached_ok", "unique_rows")
# the campaign-d4 pass: the reference's four devices (clamped to the cards
# present) and a depth-2 queue on card 0
POOLS = (4, (0, 0))
# the figures BENCH_mapper.json does not pin, held to anchors_fast.json on
# every MSE path (table3, host arithmetic, runs once)
ISOLATION = ("fig8", "fig9", "fig10", "fig12")
# the BENCH writer's run: every bench it has, a batched pass and a depth-2
# queue on card 0, the service with 4 clients and the autotune pass at the
# reference's shapes
BENCH_JSON = "results/BENCH_torch.json"
BENCH_ARGV = ["table3", "fig7", "fig8", "fig9", "fig10", "fig11", "fig12",
              "fig13", "flexion", "bridge", "--mode", "fast", "--engines",
              "batched", "--devices", "0,0", "--service", "4", "--autotune",
              "--json", str(ROOT / BENCH_JSON)]
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


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    log(f"[{name}] phase took {time.perf_counter() - t0:.1f} s")


def attention_bound_ms(h: int, s: int, d: int, dtype: str):
    """Causal attention on (h, s, d): q, k, v read once and the output
    written once, or 2*2*h*s*s*d/2 operations (the two products over the
    causal half) at the dtype's peak, whichever is longer."""
    item = {"float32": 4, "bfloat16": 2}[dtype]
    t_bytes = 4 * h * s * d * item / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * 2.0 * h * s * s * d / 2.0 / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_block_ms(h: int, s: int, d: int, bq: int, bkv: int) -> float:
    """The work the mapping really does for causal attention on (h, s, d)
    at blocks (bq, bkv): both products over every KV block up to each
    q-block's diagonal, at the float32 peak.  A design target beside the
    bound, not the yardstick."""
    blocks = sum(min(s // bkv, (qi * bq + bq - 1) // bkv + 1)
                 for qi in range(s // bq))
    return 2.0 * 2.0 * h * blocks * bq * bkv * d / PEAK_OPS["float32"] * 1e3


def scan_bound_ms(b: int, length: int, d: int, n: int):
    """Selective scan (float32): x, dt, b, c, A, D read once and y written
    once, or its operations at the float32 peak — per (t, d, n) the decay
    product and exp, two products and an add for h, a product and an add
    for <h, C> (7), per (t, d) dt*x and D*x plus an add (3) — whichever
    is longer."""
    t_bytes = (3 * b * length * d + 2 * b * length * n + d * n + d) * 4 \
        / HBM_BYTES_PER_S * 1e3
    t_ops = b * length * d * (7.0 * n + 3.0) / PEAK_OPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def zero_launches(kmods) -> None:
    for name, mod in kmods.items():
        getattr(mod, name).launches = 0


def read_launches(kmods) -> dict:
    return {name: getattr(mod, name).launches for name, mod in kmods.items()}


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


def phase_matmul_f32(torch, tm):
    """The float32 kernel at BERT ffn_up width on F32_FIXED: kernel ==
    plain, then kernel, plain and torch.matmul times beside the bound."""
    m, n, k = FULL_SHAPES["matmul"]
    rng = np.random.default_rng(3)
    x, y = (torch.as_tensor(rng.normal(size=shape).astype(np.float32)
                            ).to("cuda") for shape in ((m, k), (k, n)))
    b_ms, b_by = bound_ms(m, n, k, "float32")
    rtol, atol = TOLS["float32"]
    worst = 0.0
    for (bm, bn, bk), order in F32_FIXED:
        kw = dict(bm=bm, bn=bn, bk=bk, order=order)
        got = tm.tiled_matmul(x, y, **kw)
        want = tm.tiled_matmul_plain(x, y, **kw)
        torch.cuda.synchronize()
        check(torch.allclose(got, want, rtol=rtol, atol=atol),
              f"[matmul f32] {(bm, bn, bk)} {order}: kernel == plain")
        worst = max(worst, max_err(got, want))
        ms = bench_ms(lambda: tm.tiled_matmul(x, y, **kw))
        plain_ms = bench_ms(lambda: tm.tiled_matmul_plain(x, y, **kw),
                            reps=3, warmup=1)
        lib_ms = bench_ms(lambda: torch.matmul(x, y))
        plan = tm.launch_plan(bm, bn, bk, 4, order, x.data_ptr(),
                              y.data_ptr())
        log(f"[matmul f32] ffn_up {(m, n, k)} blocks {(bm, bn, bk)} "
            f"{order!r}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.matmul {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{100 * b_ms / ms:.1f}% of the bound; plan TM={plan.tm} "
            f"TN={plan.tn} threads={plan.threads} buffers={plan.buffers} "
            f"accumulator in "
            f"{'registers' if plan.acc_in_regs else 'shared memory'}, "
            f"x reads {'float4' if plan.x_vec else 'float'} (row "
            f"{plan.x_ld}), copies x {16 if plan.x_copy16 else 4} B / y "
            f"{16 if plan.y_copy16 else 4} B, shared memory {plan.smem} of "
            f"{int(tm.smem_bytes(bm, bn, bk, 4))} B")
    return worst


def lowbit_operands(torch, m, n, k, dt, rng):
    """Full-range operands: int8 uniform in [-128, 127], bfloat16 normal."""
    if dt == torch.int8:
        return tuple(torch.as_tensor(rng.integers(-128, 128, shape).astype(
            np.int8)).to("cuda") for shape in ((m, k), (k, n)))
    return tuple(torch.as_tensor(rng.normal(size=shape).astype(np.float32)
                                 ).to("cuda").to(dt)
                 for shape in ((m, k), (k, n)))


def phase_matmul_lowbit(torch, tm):
    """The bfloat16 and int8 kernel at BERT ffn_up width on LOWBIT_FIXED:
    kernel == plain, then kernel and plain times beside the bound and a
    yardstick: torch.matmul for bfloat16, torch._int_mm for int8 (its int32
    product, without the saturating cast)."""
    m, n, k = FULL_SHAPES["matmul"]
    rng = np.random.default_rng(4)
    worst = 0.0
    for dt in (torch.bfloat16, torch.int8):
        name = dtype_name(dt)
        x, y = lowbit_operands(torch, m, n, k, dt, rng)
        b_ms, b_by = bound_ms(m, n, k, name)
        rtol, atol = TOLS[name]
        if dt == torch.int8:
            lib, lib_name = (lambda: torch._int_mm(x, y)), (
                "torch._int_mm (int32 product, no saturating cast)")
        else:
            lib, lib_name = (lambda: torch.matmul(x, y)), "torch.matmul"
        lib_ms = bench_ms(lib)
        for (bm, bn, bk), order in LOWBIT_FIXED:
            kw = dict(bm=bm, bn=bn, bk=bk, order=order)
            got = tm.tiled_matmul(x, y, **kw)
            want = tm.tiled_matmul_plain(x, y, **kw)
            torch.cuda.synchronize()
            err = max_err(got, want)
            check(torch.allclose(got.float(), want.float(), rtol=rtol,
                                 atol=atol),
                  f"[matmul bf16/int8] {name} {(bm, bn, bk)} {order}: "
                  f"kernel == plain (max abs err {err:g})")
            worst = max(worst, err)
            ms = bench_ms(lambda: tm.tiled_matmul(x, y, **kw))
            plain_ms = bench_ms(lambda: tm.tiled_matmul_plain(x, y, **kw),
                                reps=3, warmup=1)
            plan = tm.launch_plan(bm, bn, bk, x.element_size(), order,
                                  x.data_ptr(), y.data_ptr(), m=m, n=n)
            log(f"[matmul bf16/int8] ffn_up {(m, n, k)} {name} blocks "
                f"{(bm, bn, bk)} {order!r}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, {lib_name} {lib_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.2f}% of the "
                f"bound, max abs err {err:g}; plan {describe_plan(plan)}")
    return worst


def describe_plan(plan) -> str:
    return ", ".join(f"{k}={v}" for k, v in plan._asdict().items())


def phase_attention(torch, fa):
    rng = np.random.default_rng(1)
    worst = 0.0
    for h, sq, skv, d, bq, bkv in ATTN_SWEEP:
        for dt in (torch.float32, torch.bfloat16):
            q = torch.as_tensor(rng.normal(size=(h, sq, d)).astype(
                np.float32)).to("cuda").to(dt)
            k, v = (torch.as_tensor(rng.normal(size=(h, skv, d)).astype(
                np.float32)).to("cuda").to(dt) for _ in range(2))
            for causal in (True, False):
                got = fa.flash_attention(q, k, v, causal=causal, bq=bq,
                                         bkv=bkv)
                want = fa.flash_attention_plain(q, k, v, causal=causal,
                                                bq=bq, bkv=bkv)
                torch.cuda.synchronize()
                rtol, atol = ATTN_TOLS[dtype_name(dt)]
                check(got.dtype == dt and torch.allclose(
                    got.float(), want.float(), rtol=rtol, atol=atol),
                    f"attention kernel vs plain {(h, sq, skv, d, bq, bkv)} "
                    f"causal={causal} {dt}")
                worst = max(worst, max_err(got, want))
    log(f"[kernel] attention sweep {len(ATTN_SWEEP)} shapes x causal/full "
        f"x {{f32, bf16}}: kernel == plain (max abs err {worst:.3g})")
    return worst


def scan_inputs(torch, b, length, d, n, rng):
    f = np.float32
    return tuple(torch.as_tensor(a).to("cuda") for a in (
        rng.normal(size=(b, length, d)).astype(f) * 0.5,
        rng.uniform(0.001, 0.1, (b, length, d)).astype(f),
        rng.normal(size=(b, length, n)).astype(f),
        rng.normal(size=(b, length, n)).astype(f),
        -rng.uniform(0.5, 2.0, (d, n)).astype(f), np.ones((d,), f)))


def phase_scan(torch, ms):
    rng = np.random.default_rng(2)
    worst = 0.0
    for b, length, d, n, chunk, dblk in SCAN_SWEEP:
        args = scan_inputs(torch, b, length, d, n, rng)
        got = ms.mamba_scan(*args, chunk=chunk, d_block=dblk)
        want = ms.mamba_scan_plain(*args, chunk=chunk, d_block=dblk)
        torch.cuda.synchronize()
        check(torch.allclose(got, want, rtol=SCAN_TOLS[0],
                             atol=SCAN_TOLS[1]),
              f"scan kernel vs plain {(b, length, d, n, chunk, dblk)}")
        worst = max(worst, max_err(got, want))
    log(f"[kernel] scan sweep {len(SCAN_SWEEP)} shapes: kernel == plain "
        f"(max abs err {worst:.3g})")
    return worst


def sfu_ms(b: int, length: int, d: int, n: int) -> float:
    """The selective scan's B*L*D*N exponentials at the SFU's ex2 rate on
    every SM at the card's top SM clock: a design target beside the bound,
    not the card's floor (an exponential can also run on the FMA pipes)."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    return b * length * d * n / (sms * SFU_EX2_PER_CLOCK * mhz * 1e6) * 1e3


def sass_step_loop(lib: Path, symbol: str):
    """The step loop of one kernel in a built library, read from
    ``cuobjdump -sass``: of the innermost loops (a backward branch and its
    target, with no other loop inside) of the function whose name holds
    ``symbol``, the one with the most MUFU.EX2, the shortest on a tie.
    Returns (instructions, MUFU.EX2) in its body, or None where cuobjdump
    or the function is missing."""
    import re
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    body = next((f for f in funcs[1:] if symbol in f.split("\n", 1)[0]),
                None)
    if body is None:
        return None
    insts, labels = [], {}
    for line in body.splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            labels[label.group(1)] = len(insts)
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            insts.append((int(m.group(1), 16), m.group(2)))
    at = {addr: i for i, (addr, _) in enumerate(insts)}
    loops = []
    for i, (_, text) in enumerate(insts):
        if "BRA" not in text.split():
            continue
        target = re.search(r"`\((\.L_x_\d+)\)|(0x[0-9a-f]+)", text)
        if not target:
            continue
        j = labels.get(target.group(1)) if target.group(1) else at.get(
            int(target.group(2), 16))
        if j is not None and j <= i:
            loops.append((j, i))
    inner = [(j, i) for j, i in loops
             if not any(j <= j2 and i2 <= i and (j2, i2) != (j, i)
                        for j2, i2 in loops)]
    best = max(((sum("MUFU.EX2" in t for _, t in insts[j:i + 1]),
                 -(i + 1 - j)) for j, i in inner), default=None)
    return None if best is None else (-best[1], best[0])


def phase_scan_fixed(torch, ms):
    """The scan at falcon-mamba-7b width on SCAN_FIXED: each config's time
    beside the bound and the exponential figure, its plan, and its max
    error against one run of the plain version (whose result does not
    depend on the blocks)."""
    b, length, d, n = FULL_SHAPES["mamba"]
    args = scan_inputs(torch, b, length, d, n, np.random.default_rng(5))
    want = ms.mamba_scan_plain(*args, chunk=length, d_block=d)
    b_ms, b_by = scan_bound_ms(b, length, d, n)
    e_ms = sfu_ms(b, length, d, n)
    worst = 0.0
    for chunk, dblk in SCAN_FIXED:
        got = ms.mamba_scan(*args, chunk=chunk, d_block=dblk)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(torch.allclose(got, want, rtol=SCAN_TOLS[0],
                             atol=SCAN_TOLS[1]),
              f"[scan] {(chunk, dblk)}: kernel == plain (max abs err "
              f"{err:g})")
        worst = max(worst, err)
        t_ms = bench_ms(lambda: ms.mamba_scan(*args, chunk=chunk,
                                              d_block=dblk))
        plan = ms.scan_plan(chunk, dblk, n, ms.starts_aligned(*args[:4]))
        formula = int(ms.smem_bytes(chunk, dblk, n, 4))
        check(plan.smem <= formula and (
            plan.split > 1) == (dblk > ms.cta_channels(dblk, n)),
            f"[scan] {(chunk, dblk)}: plan within the formula")
        log(f"[scan] falcon-mamba-7b {(b, length, d, n)} blocks "
            f"{(chunk, dblk)}: kernel {t_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), {100 * b_ms / t_ms:.1f}% of the bound, exp2 at the "
            f"SFU rate {e_ms:.4f} ms, max abs err {err:.3g}; plan "
            f"S={plan.states} lanes={plan.lanes} threads={plan.threads} "
            f"channels={plan.channels} split={plan.split} "
            f"passes={plan.passes} stage="
            f"{('sync', 'registers', 'halves')[plan.stage]} shared memory "
            f"{plan.smem} of {formula} B")
    return worst


def phase_attention_fixed(torch, fa, blocks=ATTN_FIXED):
    """Attention at BERT-base width on ``blocks``: each config's time beside
    the bound and the block-granular work, its plan, and its max error
    against the plain version at the same blocks."""
    h, s, d = FULL_SHAPES["attention"]
    rng = np.random.default_rng(6)
    q, k, v = (torch.as_tensor(rng.normal(size=(h, s, d)).astype(
        np.float32)).to("cuda") for _ in range(3))
    b_ms, b_by = attention_bound_ms(h, s, d, "float32")
    rtol, atol = ATTN_TOLS["float32"]
    worst = 0.0
    for bq, bkv in blocks:
        kw = dict(causal=True, bq=bq, bkv=bkv)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(torch.allclose(got, want, rtol=rtol, atol=atol),
              f"[attention] {(bq, bkv)}: kernel == plain (max abs err "
              f"{err:g})")
        worst = max(worst, err)
        t_ms = bench_ms(lambda: fa.flash_attention(q, k, v, **kw))
        formula = int(fa.smem_bytes(bq, bkv, d, 4))
        if hasattr(fa, "attention_plan"):
            plan = fa.attention_plan(bq, bkv, d, 4,
                                     fa.starts_aligned(q, k, v))
            check(plan.smem <= formula,
                  f"[attention] {(bq, bkv)}: plan within the formula")
            described = (
                f"plan threads={plan.threads} rows/warp={plan.warp_rows} "
                f"rows/thread={plan.rows} lanes/row={plan.lanes} "
                f"key_lanes={plan.key_lanes} keys/lane={plan.keys} "
                f"split={plan.split} blocks/barrier={plan.run} stage="
                f"{('split', 'double', 'direct')[plan.stage]} shared memory "
                f"{plan.smem} of {formula} B")
        else:
            described = f"no launch plan; the formula {formula} B"
        log(f"[attention] BERT-base {(h, s, d)} causal float32 blocks "
            f"{(bq, bkv)}: kernel {t_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), {100 * b_ms / t_ms:.1f}% of the bound, block work "
            f"{attention_block_ms(h, s, d, bq, bkv):.4f} ms, max abs err "
            f"{err:.3g}; {described}")
    return worst


def host_floor(torch, fa):
    """The floor under the autotune's single-call timing at BERT-base width
    and (16, 128): the wrapper's host time a call (100 calls, enqueued, then
    one synchronise), one call between two events as the bridge times it,
    and the kernel's device time from torch.profiler where it shows one.
    Run last: the profiler's tracing slowed every later launch-bound phase
    of the same process by about half."""
    h, s, d = FULL_SHAPES["attention"]
    rng = np.random.default_rng(7)
    q, k, v = (torch.as_tensor(rng.normal(size=(h, s, d)).astype(
        np.float32)).to("cuda") for _ in range(3))
    kw = dict(causal=True, bq=16, bkv=128)
    call = lambda: fa.flash_attention(q, k, v, **kw)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        call()
    enqueued = time.perf_counter() - t0
    torch.cuda.synchronize()
    waited = time.perf_counter() - t0
    single = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        single.append(start.elapsed_time(end))
    device = None
    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            if "attention_kernel" in evt.key and evt.count:
                total = getattr(evt, "device_time_total", None)
                if total is None:
                    total = getattr(evt, "cuda_time_total", 0.0)
                if total:
                    device = total / evt.count / 1e3
    except Exception as e:  # the profiler is untried on this machine
        log(f"[attention] torch.profiler failed: {e!r}")
    log(f"[attention] host floor at (16, 128): wrapper "
        f"{enqueued / 100 * 1e6:.1f} us a call enqueued (100 calls), "
        f"{waited / 100 * 1e6:.1f} us a call with the synchronise; one call "
        f"between two events (the bridge's timing) min "
        f"{min(single):.4f} ms of 5; kernel device time from torch.profiler "
        + ("not shown (no device time in key_averages)" if device is None
           else f"{device:.4f} ms"))


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


def config_calls(torch, kernels, kmods, wl, cfg, inputs):
    """(kernel, plain, library-or-None, tolerance, bound) of one lowered
    config on the workload's inputs at the config's executed width."""
    dt = kernels.dtype_for_bits(cfg.bits, wl.kind)
    if wl.kind == "matmul":
        tm = kmods["tiled_matmul"]
        x, y = (kernels.cast(a, dt) for a in inputs)
        bm, bn, bk = cfg.block
        kw = dict(bm=bm, bn=bn, bk=bk, order=cfg.order)
        m, n, k = wl.shape
        return (lambda: tm.tiled_matmul(x, y, **kw),
                lambda: tm.tiled_matmul_plain(x, y, **kw),
                library_call(x, y), TOLS[dtype_name(dt)],
                bound_ms(m, n, k, dtype_name(dt)))
    if wl.kind == "attention":
        fa = kmods["flash_attention"]
        q, k, v = (kernels.cast(a, dt) for a in inputs)
        bq, bkv = cfg.block
        sdpa = torch.nn.functional.scaled_dot_product_attention
        return (lambda: fa.flash_attention(q, k, v, causal=True, bq=bq,
                                           bkv=bkv),
                lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                                 bq=bq, bkv=bkv),
                lambda: sdpa(q, k, v, is_causal=True),
                ATTN_TOLS[dtype_name(dt)],
                attention_bound_ms(*wl.shape, dtype_name(dt)))
    ms = kmods["mamba_scan"]
    x, dtt, b, c, a, dsk = inputs
    chunk, dblk = cfg.block
    return (lambda: ms.mamba_scan(x, dtt, b, c, a, dsk, chunk=chunk,
                                  d_block=dblk),
            lambda: ms.mamba_scan_plain(x, dtt, b, c, a, dsk, chunk=chunk,
                                        d_block=dblk),
            None, SCAN_TOLS, scan_bound_ms(*wl.shape))


def check_autotune(torch, kernels, kb, kmods, derived, worst):
    """Every config the pass timed (the rank study's, the GA's and the
    max-block default) and the tuned one: legal, kernel == plain version,
    and in parity with the oracle.  Then the tuned config of each kind is
    timed against its plain version, its bound and its library call."""
    check(derived["kernels_available"], "autotune timed the kernels")
    check(derived["parity_ok"], "autotune parity_ok")
    check(derived["tuned_legal_ok"], "autotune tuned_legal_ok")
    check(derived["configs_measured"] > 0, "autotune configs_measured")
    rows = {}
    for kind, run in derived["_runs"].items():
        wl, rn, tuned = run["workload"], run["runner"], run["tuned"]
        inputs = rn.inputs_for(wl)
        configs = list(dict.fromkeys([cfg for _, cfg in rn.timed]
                                     + [tuned.config]))
        name = KIND_KERNEL[kind]
        for cfg in configs:
            check(kb.config_legal(wl, cfg), f"{kind} {cfg} legal")
            kern, plain, _, (rtol, atol), _ = config_calls(
                torch, kernels, kmods, wl, cfg, inputs)
            got, want = kern(), plain()
            check(torch.allclose(got.float(), want.float(), rtol=rtol,
                                 atol=atol), f"{kind} {cfg}: kernel == plain")
            worst[name] = max(worst[name], max_err(got, want))
            ok, err = kb.parity_check(wl, cfg, inputs)
            check(ok, f"{kind} {cfg}: parity with the oracle (err {err:g})")
        study = run["study"]
        log(f"[autotune] {kind} {wl.shape}: {len(configs)} configs timed, "
            f"all legal, kernel == plain and == oracle; spearman over "
            f"{study['n_configs']} study configs {study['spearman']!r}; "
            f"tuned blocks {tuned.config.block} {tuned.config.order!r} at "
            f"{tuned.best_cost * 1e3:.4f} ms (default "
            f"{derived[f'_default_us_{kind}'] / 1e3:.4f} ms); predicted "
            f"{tuned.predicted!r} cycles")
        for cfg in configs:
            seconds = rn.cache.get(cfg.cache_key(wl))
            log(f"[autotune]   {kind} blocks {cfg.block} {cfg.order!r}: "
                + ("not timed" if seconds is None
                   else f"{seconds * 1e3:.4f} ms"))
        kern, plain, lib, _, (b_ms, b_by) = config_calls(
            torch, kernels, kmods, wl, tuned.config, inputs)
        ms = bench_ms(kern)
        plain_ms = bench_ms(plain, reps=2, warmup=1)
        lib_ms = bench_ms(lib) if lib else None
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=lib_ms)
        log(f"[autotune] {kind} tuned config: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.4f} ms ({b_by})")
        if kind == "attention":
            # bf16 yardstick at the tuned blocks (the main path runs f32)
            cfg16 = kb.KernelConfig("attention", tuned.config.block, "", 16)
            k16, p16, l16, _, (b16, by16) = config_calls(
                torch, kernels, kmods, wl, cfg16, inputs)
            log(f"[autotune] attention bf16 at the tuned blocks: kernel "
                f"{bench_ms(k16):.4f} ms, plain "
                f"{bench_ms(p16, reps=2, warmup=1):.4f} ms, SDPA "
                f"{bench_ms(l16):.4f} ms, bound {b16:.4f} ms ({by16})")
    return rows


def public(derived: dict) -> str:
    """A bench's derived values without its timing sidecars, as text (so
    NaN equals NaN and floats compare bit for bit through repr)."""
    return repr(sorted((k, v) for k, v in derived.items()
                       if not k.startswith("_")))


def phase_dse(torch, device=None):
    """fig7 / fig11 / fig13 on every MSE path and the flexion pass, in fast
    mode on ``device`` (the card), against the committed anchors; then the
    campaign path again over device pools (the reference's campaign-d4
    pass), equal to the plain campaign bit for bit."""
    from repro_torch.bench import (fig7_tile, fig11_shape,
                                   fig13_futureproof, flexion_bench)
    with open(ROOT / "BENCH_mapper.json") as f:
        committed = json.load(f)["engines"]["batched"]
    quiet = dict(mode="fast", device=device,
                 print_fn=lambda *a, **k: None)

    def held(bench, derived, label):
        for key in ANCHORS[bench]:
            want, got = committed[bench]["derived"][key], derived[key]
            ok = (abs(got - want) <= ANCHOR_RTOL * abs(want)
                  if isinstance(want, float) else got == want)
            check(ok, f"{bench}.{key} ({label}): {got!r} vs anchor {want!r}")
        return {key: derived[key] for key in ANCHORS[bench]}

    benches = (("fig7", fig7_tile), ("fig11", fig11_shape),
               ("fig13", fig13_futureproof))
    campaign = {}
    for bench, mod in benches:
        seen = {}
        for path in ("batched", "campaign", "serial"):
            t0 = time.perf_counter()
            derived = mod.run(path=path, **quiet)
            seen[path] = held(bench, derived, path)
            log(f"[dse] {bench} {path} on the card: "
                f"{time.perf_counter() - t0:.1f} s, {seen[path]}, phases "
                f"{derived['_phases']}")
            if path == "campaign":
                campaign[bench] = public(derived)
        check(seen["serial"] == seen["batched"] == seen["campaign"],
              f"{bench}: serial, batched and campaign agree bit for bit")
    log("[dse] fig7, fig11 and fig13 anchors held at rel 1e-6 on all three "
        "paths")

    from repro_torch.core.device_pool import pool_for
    from repro_torch.core.mapper import GAConfig
    for spec in POOLS:
        # the bench hands the pool to the engine, the fixed-genome replay
        # and the flexion campaign alike
        requested = len(spec) if isinstance(spec, tuple) else spec
        pool = pool_for(GAConfig(devices=spec), device)
        for bench, mod in benches:
            t0 = time.perf_counter()
            derived = mod.run(path="campaign", devices=spec, **quiet)
            held(bench, derived, f"campaign devices={spec}")
            check(public(derived) == campaign[bench],
                  f"{bench}: campaign over devices={spec} equals the "
                  f"plain campaign bit for bit")
            log(f"[dse] campaign-d4 {bench} devices={spec!r} "
                f"(requested {requested}, available "
                f"{torch.cuda.device_count()}, pool "
                f"{[str(d) for d in pool.devices]}): "
                f"{time.perf_counter() - t0:.1f} s, equal to the plain "
                f"campaign, phases {derived['_phases']}")

    os.environ["REPRO_FLEXION_BACKEND"] = "numpy"
    t0 = time.perf_counter()
    f64 = flexion_bench.run(**quiet)
    log(f"[dse] flexion numpy float64: {time.perf_counter() - t0:.1f} s, "
        f"{held('flexion', f64, 'numpy')}")
    os.environ["REPRO_FLEXION_BACKEND"] = "torch"
    t0 = time.perf_counter()
    f32 = flexion_bench.run(**quiet)
    del os.environ["REPRO_FLEXION_BACKEND"]
    log(f"[dse] flexion torch float32 on the card: "
        f"{time.perf_counter() - t0:.1f} s")
    check(f32["campaign_matches_serial"] and f32["all_in_unit_interval"],
          "flexion torch backend: campaign == serial, fractions in [0, 1]")
    worst = max(max(abs(rep.per_axis_hf["T"] - other.per_axis_hf["T"]),
                    abs(rep.per_axis_wf["T"] - other.per_axis_wf["T"]))
                for rep, other in zip(f64["_reports"].values(),
                                      f32["_reports"].values()))
    log(f"[dse] flexion float32 vs float64: partflex1000_hf_T "
        f"{f32['partflex1000_hf_T']!r} vs {f64['partflex1000_hf_T']!r} "
        f"(diff {f32['partflex1000_hf_T'] - f64['partflex1000_hf_T']:.3g}),"
        f" fullflex1111_hf {f32['fullflex1111_hf']!r}; largest T-fraction "
        f"difference over the {len(f64['_reports'])} rows {worst:.3g}")
    dse_isolation(quiet)


def dse_isolation(quiet):
    """fig8, fig9, fig10 and fig12 on every MSE path, held to the
    reference's fast-mode values in anchors_fast.json (floats at rel 1e-6,
    booleans and counts equal), the three paths equal bit for bit; fig8's
    W-F(T) means under the card's float32 flexion beside a float64 numpy
    run; table3 once."""
    from repro_torch.bench import (fig8_buffer, fig9_order,
                                   fig10_parallelism, fig12_arraysize,
                                   table3_area)
    from repro_torch.bench._compare import derived_equal, public_derived
    from repro_torch.bench.common import fast_anchors
    anchors = fast_anchors()
    mods = {"fig8": fig8_buffer, "fig9": fig9_order,
            "fig10": fig10_parallelism, "fig12": fig12_arraysize}
    for bench in ISOLATION:
        seen = {}
        for path in ("batched", "campaign", "serial"):
            t0 = time.perf_counter()
            derived = mods[bench].run(path=path, **quiet)
            seen[path] = public_derived(derived)
            check(derived_equal(seen[path], anchors[bench],
                                rtol=ANCHOR_RTOL),
                  f"{bench} ({path}): {seen[path]} vs anchors "
                  f"{anchors[bench]}")
            log(f"[dse] {bench} {path} on the card: "
                f"{time.perf_counter() - t0:.1f} s, {seen[path]}, phases "
                f"{derived.get('_phases', {})}")
            if bench == "fig8" and path == "batched":
                wf32 = derived["_wf_t"]
        check(seen["serial"] == seen["batched"] == seen["campaign"],
              f"{bench}: serial, batched and campaign agree bit for bit")
    log("[dse] fig8, fig9, fig10 and fig12 held to anchors_fast.json at rel "
        "1e-6 on all three paths")
    os.environ["REPRO_FLEXION_BACKEND"] = "numpy"
    f64 = fig8_buffer.run(path="batched", **quiet)
    del os.environ["REPRO_FLEXION_BACKEND"]
    check(derived_equal(public_derived(f64), anchors["fig8"],
                        rtol=ANCHOR_RTOL), "fig8 with float64 flexion")
    rel = max(abs(a - b) / b for a, b in zip(wf32, f64["_wf_t"]))
    log(f"[dse] fig8 W-F(T) means by buffer size, float32 torch on the "
        f"card {wf32!r} vs float64 numpy {f64['_wf_t']!r} (largest relative "
        f"difference {rel:.3g}); wf_increases {wf32[-1] > wf32[0]} / "
        f"{f64['_wf_t'][-1] > f64['_wf_t'][0]}")
    t0 = time.perf_counter()
    t3 = table3_area.run(print_fn=quiet["print_fn"])
    check(derived_equal(t3, anchors["table3"], rtol=1e-12),
          f"table3: {t3} vs anchors {anchors['table3']}")
    log(f"[dse] table3: {time.perf_counter() - t0:.3f} s, {t3}")


def phase_bridge_validation(torch, kernels, kb, kmods, bv, worst):
    """bridge_validation's kernel section on the card: every derived gate
    true, then each lowered config held against its kernel's plain
    version on the same inputs."""
    check(bv["kernel_executed"], "bridge validation ran the kernels")
    check(bv["kernel_legality_consistent"],
          "bridge validation: legality mirror == raw_tile_feasibility")
    check(bv["kernel_parity_ok"],
          "bridge validation: every lowered config legal and in parity")
    check(bv["kernel_configs_checked"] > 0,
          "bridge validation checked configs")
    for wl, cfg in bv["_lowered"]:
        kern, plain, _, (rtol, atol), _ = config_calls(
            torch, kernels, kmods, wl, cfg, kb.make_inputs(wl))
        got, want = kern(), plain()
        check(torch.allclose(got.float(), want.float(), rtol=rtol,
                             atol=atol),
              f"bridge validation {wl.kind} {cfg}: kernel == plain")
        err = max_err(got, want)
        name = KIND_KERNEL[wl.kind]
        worst[name] = max(worst[name], err)
        log(f"[bridge validation] {wl.kind} {wl.shape} blocks {cfg.block} "
            f"{cfg.order!r} {cfg.bits} bits: legal, == oracle, kernel == "
            f"plain (max abs err {err:.3g})")
    log(f"[bridge validation] {bv['kernel_configs_checked']} configs run on "
        f"the card, all in parity; legality mirror exact; records "
        f"{'found' if bv['records_available'] else 'absent'}")


def phase_bench():
    """The port's BENCH writer over BENCH_ARGV on the card: exit 0 (its
    golden-parity gate), every pass's derived values held to the committed
    anchors, the autotune cell's gates; the Spearman signs at the
    reference's shapes printed beside the TPU's."""
    from repro_torch.bench import run as bench_run
    from repro_torch.bench._compare import derived_equal
    from repro_torch.bench.common import fast_anchors
    with open(ROOT / "BENCH_mapper.json") as f:
        committed = json.load(f)["engines"]
    want = {bench: committed["batched"][bench]["derived"]
            for bench in ("fig7", "fig11", "fig13", "flexion", "service")}
    want.update(fast_anchors())
    (ROOT / "results").mkdir(exist_ok=True)
    log_path = ROOT / "results" / "bench_run.log"
    # a JSON left by an earlier run must not pass for this one's
    (ROOT / BENCH_JSON).unlink(missing_ok=True)
    # the writer also writes results/bench_results.json under its cwd
    with open(log_path, "w") as f, contextlib.redirect_stdout(f), \
            contextlib.chdir(ROOT):
        rc = bench_run.main(BENCH_ARGV)
    check(rc == 0, f"the BENCH writer exited {rc} (its output in "
          f"{log_path.relative_to(ROOT)})")
    with open(ROOT / BENCH_JSON) as f:
        doc = json.load(f)
    check(doc["schema"] == "repro-bench-mapper/v7", "BENCH schema v7")
    for label in ("batched", "campaign-d0,0"):
        cells = doc["engines"][label]
        for bench, anchor in want.items():
            check(derived_equal(cells[bench]["derived"], anchor,
                                rtol=ANCHOR_RTOL),
                  f"[bench] {label} {bench}: {cells[bench]['derived']} vs "
                  f"{anchor}")
        bridge = cells["bridge"]["derived"]
        check(bridge["kernel_executed"] and bridge["kernel_parity_ok"],
              f"[bench] {label} bridge: {bridge}")
        log(f"[bench] {label}: us_per_call "
            f"{ {b: c['us_per_call'] for b, c in cells.items()} }")
    at = doc["engines"]["autotune"]["autotune"]
    for key in ("kernels_available", "parity_ok", "tuned_legal_ok"):
        check(at["derived"][key], f"[bench] autotune {key}")
    tpu = committed["autotune"]["autotune"]["measured"]
    for kind in ("matmul", "attention", "mamba"):
        log(f"[bench] autotune {kind} at the reference's shape: "
            f"rank_corr_positive {at['derived'][f'rank_corr_positive_{kind}']}"
            f", spearman {at['measured'][f'rank_corr_{kind}']!r} (TPU "
            f"{tpu[f'rank_corr_{kind}']!r}); tuned "
            f"{at['measured'][f'tuned_us_{kind}']} us, default "
            f"{at['measured'][f'default_us_{kind}']} us")
    log(f"[bench] writer exit 0, passes {list(doc['engines'])}, anchors "
        f"held, device_scaling {doc['device_scaling']}; "
        f"{at['derived']['configs_measured']} autotune configs measured")


def phase_pipeline(torch, device):
    """fig13's sweep rows through ``run_batched_ga`` with the pipeline off
    and on: wall times written down, results held equal."""
    import dataclasses

    from repro_torch.bench.pipeline_trace import sweep_rows
    from repro_torch.core import engine
    rows, cfg = sweep_rows()
    off = dataclasses.replace(cfg, pipeline=False)
    engine.warmup_engine(cfg, device=device)
    walls, results = {}, []
    for label, c in (("off", off), ("on", cfg), ("on", cfg), ("off", off)):
        t0 = time.perf_counter()
        results.append(engine.run_batched_ga(rows, c, device=device))
        walls.setdefault(label, []).append(time.perf_counter() - t0)
    same = all(a.best_obj == b.best_obj and a.history == b.history
               and np.array_equal(a.best_genome, b.best_genome)
               for res in results[1:] for a, b in zip(results[0], res))
    check(same, "pipelined run_batched_ga equals the plain loop")
    n_chunks = -(-len(rows) // engine.ROW_BUCKET)
    log(f"[pipeline] fig13 sweep rows: {len(rows)} rows in {n_chunks} "
        f"chunks (P={cfg.population}, G={cfg.generations}); wall, pipeline "
        f"off / on / on / off: {walls['off'][0]:.3f} / {walls['on'][0]:.3f}"
        f" / {walls['on'][1]:.3f} / {walls['off'][1]:.3f} s; results equal")


def phase_service(device):
    """The port's DSE service bench in fast mode, 4 clients, on the card:
    parity with the sequential campaigns, the cache-served repeats and the
    deterministic counts held to BENCH_mapper.json; times written down."""
    from repro_torch.bench import service_bench
    with open(ROOT / "BENCH_mapper.json") as f:
        want = json.load(f)["engines"]["batched"]["service"]["derived"]
    t0 = time.perf_counter()
    got = service_bench.run(mode="fast", clients=4, device=device,
                            print_fn=lambda *a, **k: None)
    for key in SERVICE_KEYS:
        check(got[key] == want[key],
              f"service.{key}: {got[key]!r} vs BENCH_mapper.json "
              f"{want[key]!r}")
    ph = got["_phases"]
    log(f"[service] 4 clients x {got['queries_per_client']} queries on the "
        f"card ({time.perf_counter() - t0:.1f} s in all): parity_ok, "
        f"repeat_cached_ok, unique_rows {got['unique_rows']} as pinned; "
        f"sequential {ph['sequential']:.3f} s, service {ph['service']:.3f} "
        f"s, speedup {got['_speedup_vs_sequential']}x, "
        f"{got['_throughput_qps']} queries/s; rows planned "
        f"{got['_rows_planned']}, dispatched {got['_rows_dispatched']}; "
        f"cache {got['_cache_hits']} hits / {got['_cache_misses']} misses")


def parse_blocks(text: str):
    return [tuple(int(x) for x in blk.split("x"))
            for blk in text.split(",") if blk]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--attention-only", action="store_true")
    parser.add_argument("--attention-blocks", type=parse_blocks, default=[])
    args = parser.parse_args(argv)
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
        from repro_torch import kernels
        from repro_torch.bench import autotune, bridge_validation
        from repro_torch.core import kernel_bridge as kb
        from repro_torch.kernels import _build
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import mamba_scan as ms
        from repro_torch.kernels import tiled_matmul as tm
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    kmods = {"tiled_matmul": tm, "flash_attention": fa, "mamba_scan": ms}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] csrc/*.cu for sm_90a in {time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        ptxas = _build.build_log(name).splitlines()
        regs = sorted({line.split("Used ")[1].split(" registers")[0]
                       for line in ptxas if "registers" in line})
        spills = sorted({line.strip() for line in ptxas if "spill" in line})
        log(f"[build] {name} instantiations use {regs} registers; {spills}")
    if args.attention_only:
        extra = [b for b in args.attention_blocks if b not in ATTN_FIXED]
        with phase("attention"):
            phase_attention_fixed(torch, fa, ATTN_FIXED + extra)
            host_floor(torch, fa)
        log(smi)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    loop = sass_step_loop(_build._target(_build.CSRC / "mamba_scan.cu"),
                          "scan_kernelILi4ELi4ELb1E")
    log(f"[build] mamba_scan step loop of the S=4, lanes=4 instantiation "
        f"(unrolled by 4): "
        + ("cuobjdump not found" if loop is None else
           f"{loop[0]} SASS instructions, {loop[1]} MUFU.EX2"))

    worst = dict.fromkeys(KERNELS, 0.0)
    with phase("kernel"):
        worst["tiled_matmul"] = phase_kernel(torch, tm)
        worst["flash_attention"] = phase_attention(torch, fa)
        worst["mamba_scan"] = phase_scan(torch, ms)
    with phase("matmul f32"):
        worst["tiled_matmul"] = max(worst["tiled_matmul"],
                                    phase_matmul_f32(torch, tm))
    with phase("matmul bf16/int8"):
        worst["tiled_matmul"] = max(worst["tiled_matmul"],
                                    phase_matmul_lowbit(torch, tm))
    with phase("scan"):
        worst["mamba_scan"] = max(worst["mamba_scan"],
                                  phase_scan_fixed(torch, ms))
    with phase("attention"):
        worst["flash_attention"] = max(worst["flash_attention"],
                                       phase_attention_fixed(torch, fa))

    # ---- main path 1, search -> bridge: counts zeroed before, read after --
    zero_launches(kmods)
    with phase("search"):
        layers, specs, results, walls = phase_search(core)
    runner = kb.MeasuredRunner(repeats=3, warmup=1)
    with phase("bridge"):
        rows = bert_bridge(core, kb, layers, specs, results, runner)
    path1 = read_launches(kmods)
    # ----------------------------------------------------------------------
    check(path1["tiled_matmul"] > 0, "search -> bridge launched tiled_matmul")
    log(f"[main path] search -> bridge launches: {path1}")
    check_search(core, layers, specs, results, walls)
    worst["tiled_matmul"] = max(worst["tiled_matmul"], check_bridge(
        torch, kernels, tm, rows, runner))

    # ---- main path 2, autotune: counts zeroed before, read after ---------
    zero_launches(kmods)
    with phase("autotune"):
        derived = autotune.run(mode="fast", shapes=FULL_SHAPES, print_fn=log)
    path2 = read_launches(kmods)
    # ----------------------------------------------------------------------
    log(f"[main path] autotune launches: {path2}")
    for name in KERNELS:
        check(path2[name] > 0, f"autotune launched {name}")
    with phase("autotune checks"):
        timing = check_autotune(torch, kernels, kb, kmods, derived, worst)

    # ---- main path 3, bridge validation: counts zeroed before, read after
    zero_launches(kmods)
    with phase("bridge validation"):
        bv = bridge_validation.run(print_fn=log)
    path3 = read_launches(kmods)
    # ----------------------------------------------------------------------
    log(f"[main path] bridge validation launches: {path3}")
    for name in KERNELS:
        check(path3[name] > 0, f"bridge validation launched {name}")
    phase_bridge_validation(torch, kernels, kb, kmods, bv, worst)

    with phase("dse"):
        phase_dse(torch)
    with phase("pipeline"):
        phase_pipeline(torch, "cuda")
    with phase("service"):
        phase_service("cuda")

    # ---- main path 4, the BENCH writer: counts zeroed before, read after -
    zero_launches(kmods)
    with phase("bench"):
        phase_bench()
    path4 = read_launches(kmods)
    # ----------------------------------------------------------------------
    log(f"[main path] bench launches: {path4}")
    for name in KERNELS:
        check(path4[name] > 0, f"the BENCH writer launched {name}")

    with phase("attention host floor"):
        host_floor(torch, fa)

    launches = {name: path1[name] + path2[name] + path3[name] + path4[name]
                for name in KERNELS}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [dict(
        name=name, route="cuda",
        source=f"src/repro_torch/kernels/csrc/{name}.cu",
        replaces=REPLACES[name], launches=launches[name],
        max_abs_err=worst[name], **timing[name]) for name in KERNELS]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
