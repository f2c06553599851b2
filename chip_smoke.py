#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Builds the CUDA kernels from this checkout, holds each against its plain
PyTorch version, then drives the port's main paths as a user would call
them:

  1. kernel — each Hopper kernel against its plain version: tiled_matmul on
     the kernel test sweep plus the odd blocks the bridge lowers (11 shapes
     x 3 orders x {f32, bf16, int8}) and the int8 overflow case;
     flash_attention at f32 and bf16, causal and full, on the attention
     sweep plus an odd and a size-1 block and a shape for each branch of
     its launch plan (bf16 also at the tight ATTN_TIGHT); mamba_scan on the
     scan sweep
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
     causal) on fixed (bq, bkv), float32 then bfloat16: kernel ms beside
     the bound (and, float32, the mapping's block-granular work), the plain
     version's ms, SDPA's fastest backend on (1, H, S, d) views (each
     backend forced in turn, held against the kernel, refusals logged),
     the launch plan and its body, the max error against the plain version;
     at bfloat16 the other body timed beside it, both bodies also held at
     ATTN_TIGHT, whose control (a skipped diagonal KV block) it must
     reject, and the tensor-core body's SASS must hold HMMA
     (``[attention]``); then the model path's attention kernels
     (``attention_train``: bf16 flash forward and backward) at the cells'
     shapes, a GQA 32/2 shape and an offset chunk: forward and backward
     ms by CUDA events beside the bound at 989 TFLOP/s, the plain op's
     and the flash twin's ms on batch row 0, SDPA's default backend as
     the library yardstick where the offset is 0, o, lse, dq, dk and dv
     against the plain op row by row on the first and the last batch
     row, and a second backward bit-identical (``[attention train]``);
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
  7b. analysis — the port's invariant linter (``python -m
     repro_torch.analysis --format json --budget-seconds 120``) in a
     process of its own on this machine, which has no jax: exit 0, ``ok``,
     every ``.py`` under src/repro_torch scanned, ``--list-rules`` giving
     REP000-REP009; then a concurrent DSE service pass on the card (4
     clients) with the port's four real locks wrapped in recording proxies
     (a control order first): every order taken is in the static REP007
     graph ``lock_order_edges`` derives for src/repro_torch, and every
     answer equals its solo campaign;
  8. bridge validation — the port's bridge_validation bench on the card:
     genomes sampled on ``make_variant("11001")`` for a 32x32x32 matmul,
     (1, 32, 16) attention and a (1, 16, 8, 4) scan, lowered, checked legal
     and run on all three kernels against the oracle, each lowered config
     also held against the kernel's plain version; the legality mirror
     against ``raw_tile_feasibility`` on the card;
  9. bench — the port's BENCH writer (``repro_torch.bench.run``) in fast
     mode on each of its paths: a batched pass and a pass over
     ``--devices 0,0`` (a depth-2 queue on card 0, which also carries the
     flexion campaign) over table3, fig7, fig9, fig11, fig13 and flexion,
     the service bench with 4 clients and the autotune pass at the
     reference's own shapes, written to ``results/BENCH_torch.json``:
     exit 0 (its golden-parity gate across passes), table3 / fig9 equal to
     anchors_fast.json and fig7 / fig11 / fig13 / flexion / service to
     BENCH_mapper.json's batched cell at rel 1e-6, the autotune cell's
     parity, legality and availability gates; its three Spearman signs
     printed beside the TPU's (fig8, fig10 and fig12 are held by phase 5,
     bridge_validation by phase 8); ``python -m
     repro_torch.bench.diff_bench --self-check`` exits 0 and the artifact
     lacks no metric of its REQUIRED_KEYS;
 10. model — every architecture of ``repro_torch.configs.ARCHS`` at its
     smoke config on the card, float32: params drawn by numpy in the
     reference's layout (their checksum first), forward logits, aux and
     loss, prefill and 3 greedy decode steps held to the reference's
     outputs pinned in ``src/repro_torch/models/anchors_smoke.json``;
 11. train — every architecture of ``repro_torch.configs.ARCHS`` at its
     smoke config trained on the card, float32: the loss and every
     gradient leaf, two ``default_optimizer`` steps and one SGD step in two
     microbatches held to the reference's outputs pinned in
     ``src/repro_torch/models/anchors_train_smoke.json``; then
     ``launch.train.run_training`` of stablelm-3b smoke for 30 steps with
     a fault at step 17: one restart, a falling loss, and a final
     checkpoint equal bit for bit to a fault-free run's;
 12. train full — gemma-2b at its published widths and depth, bfloat16,
     remat on, batch 4 x 512: remat on and off give the same gradients
     (and unbound stacked leaves those of a layer taken at a time, both
     timed); ``run_training(..., smoke=False, steps=4)`` as a user calls
     it, with tok/s, peak memory and its checkpoint's size and write time;
     that checkpoint restored onto the card and 3 more steps timed, with
     MFU and the optimizer update's byte bound;
 13. dist — sharded training and serving through the distribution layer
     on a ('data', 'model') mesh of (1, 1) over an NCCL process group of
     world size 1 (opened from a FileStore, destroyed after): every smoke
     arch's ``jit_train_step`` (2 default-optimizer steps, FSDP off and
     on), ``jit_prefill_step`` and 3 ``jit_serve_step`` steps against the
     one-device steps, the worst gap printed per arch; then gemma-2b at
     its published widths and depth, bf16, remat and FSDP on, trained 3
     steps through ``run_training`` with the group open (as under
     ``torchrun --nproc-per-node 1``): ms a step (CUDA events), tok/s, peak
     memory and the gap to phase 12's one-device steps;
 15. dryrun — the dry-run group (``launch/dryrun.py`` on fake tensors
     over a fake process group, in subprocesses, nothing allocated on the
     card): gemma-2b x train_4k on the 16x16 fake mesh through ``python -m
     repro_torch.launch.dryrun`` (status ok, per-device memory and the
     roofline terms); phase 12's configuration dry-run on a (1, 1) mesh
     against one real step of it on the card (argument bytes and FLOPs
     equal, the predicted peak within DRYRUN_PEAK_BAND of the measured
     one, the measured step beside ``bound_s``); bridge_validation's
     section 1 records written and read (``records_available``, and the
     1x256 mesh's memory term under a quarter of 16x16's); the BENCH
     writer's ``roofline`` pass over the first cell's record; the first
     cell's peak under 80 GB a device; olmoe-1b-7b x train_4k,
     zamba2-2.7b x decode_32k and whisper-base x train_4k on the 16x16
     fake mesh, each at status ok;
 16. examples — the five twins of ``examples/`` (``repro_torch.examples``)
     as a user runs them, on the card: quickstart, futureproof_whatif and
     autoshard_tops printing what they print on the host's CPU,
     serve_batched (12 requests of 24 tokens, gemma-2b smoke) and
     train_end_to_end at ``--smoke`` (lm-100m, 200 steps, one injected
     fault and its restart);
 14. serve — gemma-2b at its published widths and depth (18 layers,
     d_model 2048, MQA, d_ff 16384, vocab 256000), bfloat16, answering 8
     requests in waves of 4 through ``launch.serve.run_serving`` as a user
     calls it; prefill and decode timed (medians of 5 runs: the step is
     host-bound); then on the same params in float32: prefill == forward, prefill + decode == teacher forcing and
     a 2048-token prefill through the flash twin == dense attention; the
     bf16 run against float32 and the peak device memory as findings.

Phase 5 also runs fig8, fig9, fig10 and fig12 in fast mode on all three MSE
paths, held to the reference's fast-mode values pinned in
``src/repro_torch/bench/anchors_fast.json`` (floats at rel 1e-6, booleans
equal), the paths equal bit for bit, with fig8's W-F(T) means under the
card's float32 flexion beside a float64 numpy run; and table3 once.

Then the wrapper's host time a call at the tuned attention blocks, float32
and bfloat16, beside the kernel's device time from torch.profiler
(``[attention host floor]``),
and last, since the profiler slows every later launch-bound call, a
torch.profiler trace of 8 bf16 gemma-2b decode steps: kernels a step, the
card's busy time a step and its idle share of phase 14's unprofiled decode
step (``[decode trace]``).

Phases 2-3 (search -> bridge), phase 4 (autotune), phase 7b (analysis),
phase 8 (bridge validation), phase 9 (bench), phases 11-12 (training), phase 13 (sharded
training and serving), phase 15 (the dry-run), phase 16 (the examples;
both run before phase 14) and phase 14 (serve) are the main paths: the
kernel
launch counts are zeroed before each and read after it, the attention's
also by body (the model layers run the reference's twins, so training,
sharded or not, and serving launch none).  Any failed check ends the run
with a non-zero exit.  The last lines are the
kernel table as JSON, the card's name and power limit, and
``{"ok": true, "device": ...}``.

    python3 chip_smoke.py        # from the root of a checkout, one card

``--dryrun-only`` runs the ``[dryrun]`` phase alone, without the kernels'
build.  ``--attention-train-only`` builds the kernels and runs the
``[attention train]`` and ``[model attention]`` phases alone.
``--attention-only`` builds the kernels and runs the ``[attention]`` phase
alone, at ATTN_FIXED and at the blocks ``--attention-blocks`` adds
(``16x128,256x2``): copied into another checkout, it times that checkout's
kernel on the same configs (a kernel without a launch plan prints none).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
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
# config; then one for each branch of the bfloat16 tensor-core plan: four
# key warps at bq = 16, d = 256 in column passes beside two key warps, d = 12
# zero-padded, blocks of 24 and 48 keys, Sq != Skv causal both ways; (rtol,
# atol) per dtype as in that test
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
              (2, 64, 256, 64, 2, 128), (12, 512, 512, 64, 256, 2),
              (2, 128, 128, 64, 16, 64), (1, 64, 64, 256, 32, 32),
              (2, 64, 64, 12, 16, 32), (2, 96, 96, 64, 32, 24),
              (2, 96, 96, 32, 16, 48), (1, 48, 96, 64, 16, 48),
              (1, 96, 48, 64, 48, 16)]
ATTN_TOLS = {"float32": (2e-5, 1.6e-4), "bfloat16": (3e-2, 0.24)}
# bfloat16 attention is also held to a tight (rtol, atol) beside ATTN_TOLS:
# the sound bodies differ from the plain version by at most one bf16 ulp
# (7.81e-3 over the sweep), while a body that skips the diagonal KV block
# of the last q-block moves those rows by up to ~0.1-0.2 and still passes
# ATTN_TOLS (the control in [attention] shows both)
ATTN_TIGHT = {"float32": ATTN_TOLS["float32"], "bfloat16": (1e-2, 1e-2)}
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
            "mamba_scan": "src/repro/kernels/mamba_scan.py:58",
            "attention_train": "src/repro/models/attention.py:69"}
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
LINT_BUDGET_S = 120         # --budget-seconds of the port's linter
LINT_CODES = tuple(f"REP00{i}" for i in range(10))
ANALYSIS_CLIENTS = 4       # concurrent clients of the lock-order pass
LOCK_IDS = ("repro_torch.core.flexion_batched._TABLE_LOCK",
            "repro_torch.core.result_cache.ResultCache._lock",
            "repro_torch.serve.dse_service.DSEService._lock",
            "repro_torch.kernels._build._LOCK")
SERVICE_KEYS = ("clients", "queries_per_client", "parity_ok",
                "repeat_cached_ok", "unique_rows")
# the campaign-d4 pass: the reference's four devices (clamped to the cards
# present) and a depth-2 queue on card 0
POOLS = (4, (0, 0))
# the figures BENCH_mapper.json does not pin, held to anchors_fast.json on
# every MSE path (table3, host arithmetic, runs once)
ISOLATION = ("fig8", "fig9", "fig10", "fig12")
# the BENCH writer's run: each of its paths once — a batched pass and a
# depth-2 queue on card 0 (the parity gate between them; the queue also
# carries the flexion campaign), the service with 4 clients and the autotune
# pass at the reference's shapes (all three kernels); fig8, fig10, fig12 and
# bridge_validation are left to [dse] and [bridge validation], which hold
# the same anchors in the same run, and fig9 stands for them on the queue
BENCH_JSON = "results/BENCH_torch.json"
BENCH_BENCHES = ("table3", "fig7", "fig9", "fig11", "fig13", "flexion",
                 "service")
BENCH_ARGV = [*BENCH_BENCHES[:-1], "--mode", "fast", "--engines", "batched",
              "--devices", "0,0", "--service", "4", "--autotune", "--json",
              str(ROOT / BENCH_JSON)]
# [model]: the smoke configs on the card against anchors_smoke.json
MODEL_TOL = 2e-4
# [serve]: gemma-2b at its published widths and depth, served through
# launch.serve as a user calls it, then checked in float32
SERVE_ARCH = "gemma-2b"
SERVE_REQUESTS, SERVE_BATCH, SERVE_NEW = 8, 4, 16
SERVE_PROMPT = 32          # the timed prefill: 4 prompts of 32 tokens
SERVE_RUNS = 5             # timed prefill + decode runs, their median kept
FORWARD_TOL = 2e-4         # tests/test_models.py: prefill == forward
TEACHER_TOL = 5e-3         # tests/test_models.py: decode == teacher forcing
FLASH_LEN = 2048           # > 1024: 'auto' takes the flash twin
# [train]: the smoke configs trained on the card against
# anchors_train_smoke.json, then the restart check through the launcher
# (tests/test_serving_and_data.py's end-to-end run)
RESTART_ARCH = "stablelm-3b"
RESTART_RUN = dict(smoke=True, steps=30, batch=4, seq=32, ckpt_every=10,
                   optimizer="adamw", lr=3e-3, log_every=100, seed=0)
RESTART_FAIL_AT = (17,)
# [train full]: gemma-2b at its published widths and depth, bf16, remat on
TRAIN_ARCH = "gemma-2b"
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_STEPS, TRAIN_MORE = 4, 3
# [dist]: the 1x1 mesh's steps against one device at the train anchors'
# tolerances (losses relative, params a share of a leaf's largest) and
# [model]'s for logits; then gemma-2b at full width trained DIST_STEPS steps
DIST_BATCH, DIST_SEQ, DIST_DECODE = 4, 16, 3
DIST_LOSS_RTOL, DIST_PARAM_TOL, DIST_LOGIT_ATOL = 1e-5, 1e-4, 2e-4
DIST_STEPS = 3
# [dryrun]: the production cell, the [train full] configuration on a (1, 1)
# mesh against one real step on the card, and bridge_validation's §1 pair;
# the predicted peak over the measured one must lie in DRYRUN_PEAK_BAND
# (MemTracker counts tensors; the allocator rounds each block up to 512 B
# and keeps what a stream still uses)
DRYRUN_CELL = ["--arch", "gemma-2b", "--shape", "train_4k"]
# the production cell's peak a device must fit the card's 80 GB
DRYRUN_PEAK_LIMIT = 80e9
# cells of other archs on the 16x16 fake mesh, each to reach status ok
DRYRUN_CELLS = [["--arch", "olmoe-1b-7b", "--shape", "train_4k"],
                ["--arch", "zamba2-2.7b", "--shape", "decode_32k"],
                ["--arch", "whisper-base", "--shape", "train_4k"]]
DRYRUN_SECTION1 = [
    ["--tag", "long_i0_falcon_base_refresh"],
    ["--mesh-shape", "1x256", "--tag", "long_i1_falcon_mesh1x256"]]
DRYRUN_PEAK_BAND = (0.9, 1.1)
DRYRUN_TIMEOUT = 600
# [examples]: the twins of examples/ as a user runs them; train_end_to_end
# at --smoke and its default 200 steps (a fault injected at step 100)
EXAMPLES_DSE = ("quickstart", "futureproof_whatif", "autoshard_tops")
EXAMPLES_TRAIN_ARGV = ["--smoke"]
EXAMPLES_TRAIN_STEPS = 200
# a param's update in bytes: p, g read and p written in bf16 (6 B), and for
# AdamW m and v read and written in float32 (16 B more)
UPDATE_BYTES = {"auto": 22, "sgd": 6}
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


def graph_ms(fn, reps: int = 10, replays: int = 3) -> float:
    """Mean device milliseconds of ``fn`` without the host between calls:
    ``reps`` calls captured in one CUDA graph (after a warm call on the
    capture's side stream), replayed ``replays`` times between two events.
    Where the host's time a call exceeds the kernel's, :func:`bench_ms`
    measures the host; this measures the card."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


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


def sdpa_call(torch, q, k, v):
    """PyTorch's scaled_dot_product_attention on the kernel's (H, S, d)
    operands as (1, H, S, d) views (its fused backends take 4-D inputs
    only), causal, at its default scale d**-0.5 (the kernel's); returns
    (H, S, d)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = q[None], k[None], v[None]
    return lambda: sdpa(q4, k4, v4, is_causal=True)[0]


def sdpa_backends(torch, call, want, tols, label):
    """``call`` (an :func:`sdpa_call`) forced onto each SDPA backend in
    turn (flash, at 16 bits only; memory-efficient; cuDNN, where this torch
    has it; math): each that accepts is held against ``want`` at ``tols``
    and timed, calls back to back and on the device alone (a CUDA graph;
    "not measured" where capture is refused); each that refuses is logged
    as refused.  Returns the fastest call (ms, backend name)."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    names = ["EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH"]
    if want.dtype != torch.float32:
        names.insert(0, "FLASH_ATTENTION")
    times, devices, parts = {}, {}, []
    for name in names:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            parts.append(f"{name} absent from this torch")
            continue
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                with sdpa_kernel(backend):
                    got = call()
                    torch.cuda.synchronize()
                    ms = bench_ms(call)
            except RuntimeError as e:
                parts.append(f"{name} refused ({str(e).splitlines()[0]})")
                continue
            try:
                with sdpa_kernel(backend):
                    devices[name] = graph_ms(call)
                device = f"{devices[name]:.4f} ms"
            except RuntimeError as e:
                device = f"not measured ({str(e).splitlines()[0]})"
        err = max_err(got, want)
        check(torch.allclose(got.float(), want.float(), rtol=tols[0],
                             atol=tols[1]),
              f"{label}: SDPA {name} == the kernel (max abs err {err:g})")
        times[name] = ms
        parts.append(f"{name} {ms:.4f} ms, device {device} (max abs err "
                     f"{err:.3g})")
    check(bool(times), f"{label}: some SDPA backend ran")
    best = min(times, key=times.get)
    on_card = (f"; fastest on the device {min(devices, key=devices.get)}"
               if devices else "")
    log(f"{label} SDPA on (1, H, S, d) views, causal, TF32 off: "
        f"{'; '.join(parts)}; fastest call {best}{on_card}")
    return times[best], best


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
    op = kmods["attention_train"].attention_train
    op.backward_launches = 0
    fn = kmods["flash_attention"].flash_attention
    if hasattr(fn, "body_launches"):
        fn.body_launches = [0, 0]


def read_launches(kmods) -> dict:
    return {name: getattr(mod, name).launches for name, mod in kmods.items()}


def attention_bodies(kmods) -> str:
    """The attention launches since :func:`zero_launches`, by body."""
    cores, tensor = kmods["flash_attention"].flash_attention.body_launches
    return f"flash_attention by body: CUDA cores {cores}, tensor cores {tensor}"


def attention_close(torch, got, want, name: str) -> bool:
    """Kernel == plain at ATTN_TOLS and at ATTN_TIGHT."""
    return all(torch.allclose(got.float(), want.float(), rtol=rtol,
                              atol=atol)
               for rtol, atol in (ATTN_TOLS[name], ATTN_TIGHT[name]))


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
                check(got.dtype == dt and attention_close(
                    torch, got, want, dtype_name(dt)),
                    f"attention kernel vs plain {(h, sq, skv, d, bq, bkv)} "
                    f"causal={causal} {dt}")
                worst = max(worst, max_err(got, want))
    log(f"[kernel] attention sweep {len(ATTN_SWEEP)} shapes x causal/full "
        f"x {{f32, bf16}}: kernel == plain at ATTN_TOLS and ATTN_TIGHT (max "
        f"abs err {worst:.3g})")
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


def sass_functions(lib: Path, symbol: str):
    """{name: SASS text} of the functions of a built library whose name
    holds ``symbol``, from ``cuobjdump -sass``; None where cuobjdump is
    missing."""
    import re
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    funcs = (f.partition("\n") for f in re.split(r"\n\s*Function : ",
                                                 sass)[1:])
    return {name.strip(): body for name, _, body in funcs if symbol in name}


def sass_step_loop(lib: Path, symbol: str):
    """The step loop of one kernel in a built library, read from
    ``cuobjdump -sass``: of the innermost loops (a backward branch and its
    target, with no other loop inside) of the function whose name holds
    ``symbol``, the one with the most MUFU.EX2, the shortest on a tie.
    Returns (instructions, MUFU.EX2) in its body, or None where cuobjdump
    or the function is missing."""
    import re
    body = next(iter((sass_functions(lib, symbol) or {}).values()), None)
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


def sass_opcode_counts(lib: Path, symbol: str, opcode: str):
    """{function: instructions whose opcode starts with ``opcode``} over the
    functions of a built library whose name holds ``symbol``; None where
    cuobjdump is missing."""
    import re
    funcs = sass_functions(lib, symbol)
    if funcs is None:
        return None
    inst = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?" + opcode)
    return {name: sum(1 for line in body.splitlines() if inst.match(line))
            for name, body in funcs.items()}


def describe_attention_plan(plan, formula: int) -> str:
    if getattr(plan, "body", 0) == 1:
        return (f"tensor-core body: threads={plan.threads} "
                f"key_warps={plan.key_warps} keys/warp/chunk={plan.keys} "
                f"chunks={plan.chunks} split={plan.split} "
                f"col_passes={plan.col_passes} copies={2 * plan.vec} B "
                f"blocks/barrier={plan.run} stage="
                f"{('split', 'double', 'direct')[plan.stage]} shared memory "
                f"{plan.smem} of {formula} B")
    return (f"CUDA-core body: threads={plan.threads} "
            f"rows/warp={plan.warp_rows} rows/thread={plan.rows} "
            f"lanes/row={plan.lanes} key_lanes={plan.key_lanes} "
            f"keys/lane={plan.keys} split={plan.split} "
            f"blocks/barrier={plan.run} stage="
            f"{('split', 'double', 'direct')[plan.stage]} shared memory "
            f"{plan.smem} of {formula} B")


def phase_attention_fixed(torch, fa, blocks=ATTN_FIXED):
    """Attention at BERT-base width on ``blocks``, float32 then bfloat16:
    each config's time beside the bound, the block-granular work (float32),
    the plain version's time and SDPA's fastest backend (timed once a
    dtype: it has no blocks), its plan and its max error against the plain
    version at the same blocks.  Each kernel time is given twice: calls
    back to back (:func:`bench_ms`, which the host bounds where its time a
    call exceeds the kernel's) and on the device alone (:func:`graph_ms`).
    At bfloat16 the other body is timed and checked too where it runs (the
    CUDA-core body beside the tensor-core one, the tensor-core body at thin
    blocks), and every tensor-core instantiation's SASS must hold HMMA."""
    h, s, d = FULL_SHAPES["attention"]
    rng = np.random.default_rng(6)
    base = [rng.normal(size=(h, s, d)).astype(np.float32) for _ in range(3)]
    worst = 0.0
    if hasattr(fa, "mma_plan"):
        from repro_torch.kernels import _build
        counts = sass_opcode_counts(
            _build._target(_build.CSRC / "flash_attention.cu"),
            "attention_mma_kernel", "HMMA")
        check(bool(counts) and all(counts.values()),
              f"[attention] every tensor-core instantiation holds HMMA "
              f"({counts})")
        log(f"[attention] tensor-core body SASS: "
            + ", ".join(f"{n} HMMA" for n in counts.values())
            + f" in its {len(counts)} instantiations")
    for dt in (torch.float32, torch.bfloat16):
        name = dtype_name(dt)
        q, k, v = (torch.as_tensor(a).to("cuda").to(dt) for a in base)
        b_ms, b_by = attention_bound_ms(h, s, d, name)
        rtol, atol = ATTN_TOLS[name]
        lib_ms, lib_name = sdpa_backends(
            torch, sdpa_call(torch, q, k, v),
            fa.flash_attention(q, k, v, causal=True, bq=16, bkv=128),
            (rtol, atol), f"[attention] BERT-base {(h, s, d)} {name}")
        for bq, bkv in blocks:
            kw = dict(causal=True, bq=bq, bkv=bkv)
            got = fa.flash_attention(q, k, v, **kw)
            want = fa.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = max_err(got, want)
            check(attention_close(torch, got, want, name),
                  f"[attention] {name} {(bq, bkv)}: kernel == plain (max abs "
                  f"err {err:g})")
            worst = max(worst, err)
            if dt == torch.bfloat16 and (bq, bkv) == ATTN_FIXED[0]:
                attention_control(torch, q, k, v, want, bq, bkv, err)
            t_ms = bench_ms(lambda: fa.flash_attention(q, k, v, **kw))
            dev_ms = graph_ms(lambda: fa.flash_attention(q, k, v, **kw))
            plain_ms = bench_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                                 **kw),
                                reps=2, warmup=1)
            formula = int(fa.smem_bytes(bq, bkv, d, q.element_size()))
            other = ""
            if hasattr(fa, "attention_plan"):
                aligned = fa.starts_aligned(q, k, v)
                plan = fa.attention_plan(bq, bkv, d, q.element_size(),
                                         aligned)
                check(plan.smem <= formula,
                      f"[attention] {(bq, bkv)}: plan within the formula")
                described = describe_attention_plan(plan, formula)
                if dt == torch.bfloat16 and hasattr(fa, "mma_plan"):
                    alt = (fa.core_plan(bq, bkv, d, 2, aligned)
                           if plan.body == fa.BODY_TENSOR
                           else fa.mma_plan(bq, bkv, d, aligned))
                    if alt is not None:
                        call = lambda: fa.launch(q, k, v, scale=d ** -0.5,
                                                 plan=alt, **kw)
                        alt_got = call()
                        alt_err = max_err(alt_got, want)
                        check(attention_close(torch, alt_got, want, name),
                              f"[attention] {(bq, bkv)}: the other body "
                              f"== plain (max abs err {alt_err:g})")
                        other = (f"; the other body "
                                 f"({describe_attention_plan(alt, formula)})"
                                 f" {bench_ms(call):.4f} ms, device "
                                 f"{graph_ms(call):.4f} ms, max abs err "
                                 f"{alt_err:.3g}")
            else:
                described = f"no launch plan; the formula {formula} B"
            work = (f"block work {attention_block_ms(h, s, d, bq, bkv):.4f}"
                    f" ms, " if dt == torch.float32 else "")
            log(f"[attention] BERT-base {(h, s, d)} causal {name} blocks "
                f"{(bq, bkv)}: kernel {t_ms:.4f} ms, device {dev_ms:.4f} "
                f"ms, bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / dev_ms:.1f}%"
                f" of the bound on the device, {work}"
                f"plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms ({lib_name}),"
                f" max abs err {err:.3g}; {described}{other}")
    return worst


def attention_control(torch, q, k, v, want, bq, bkv, err) -> None:
    """The tight bfloat16 check's control: the plain output with the rows
    of the last q-block that reach the last KV block recomputed without it,
    as a body that skipped its diagonal block there would give.  ATTN_TIGHT
    must reject it; whether ATTN_TOLS does is logged beside the kernel's
    own error."""
    h, s, d = q.shape
    k0 = s - bkv                       # the last KV block's first key
    first = max(s - bq, k0)            # rows that see it
    logits = q[:, first:].float() @ k[:, :k0].float().transpose(1, 2)
    bad = want.clone()
    bad[:, first:] = (torch.softmax(logits * d ** -0.5, dim=-1)
                      @ v[:, :k0].float()).to(want.dtype)
    name = dtype_name(q.dtype)
    tight, loose = (torch.allclose(bad.float(), want.float(), rtol=rtol,
                                   atol=atol)
                    for rtol, atol in (ATTN_TIGHT[name], ATTN_TOLS[name]))
    check(not tight, f"[attention] control {(bq, bkv)}: ATTN_TIGHT rejects "
          f"a skipped diagonal block")
    log(f"[attention] control at {(bq, bkv)} {name}: the last KV block "
        f"skipped for rows {first}..{s - 1} differs from plain by max "
        f"{max_err(bad, want):.3g}; ATTN_TIGHT {ATTN_TIGHT[name]} rejects it, "
        f"ATTN_TOLS {ATTN_TOLS[name]} "
        f"{'accepts' if loose else 'rejects'} it; the kernel's max abs err "
        f"{err:.3g}")


def host_floor(torch, fa):
    """The floor under the autotune's single-call timing at BERT-base width
    and (16, 128), float32 and bfloat16: the wrapper's host time a call (100
    calls, enqueued, then one synchronise), one call between two events as
    the bridge times it, and the kernel's device time from torch.profiler
    where it shows one (bfloat16: the tensor-core body).  Run last: the
    profiler's tracing slowed every later launch-bound phase of the same
    process by about half."""
    h, s, d = FULL_SHAPES["attention"]
    rng = np.random.default_rng(7)
    base = [rng.normal(size=(h, s, d)).astype(np.float32) for _ in range(3)]
    kw = dict(causal=True, bq=16, bkv=128)
    for dt, body in ((torch.float32, "attention_kernel"),
                     (torch.bfloat16, "attention_mma_kernel")):
        q, k, v = (torch.as_tensor(a).to("cuda").to(dt) for a in base)
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
                if body + "<" in evt.key and evt.count:
                    total = getattr(evt, "device_time_total", None)
                    if total is None:
                        total = getattr(evt, "cuda_time_total", 0.0)
                    if total:
                        device = total / evt.count / 1e3
        except Exception as e:  # the profiler is untried on this machine
            log(f"[attention] torch.profiler failed: {e!r}")
        log(f"[attention] host floor at (16, 128) {dtype_name(dt)}: wrapper "
            f"{enqueued / 100 * 1e6:.1f} us a call enqueued (100 calls), "
            f"{waited / 100 * 1e6:.1f} us a call with the synchronise; one "
            f"call between two events (the bridge's timing) min "
            f"{min(single):.4f} ms of 5; {body} device time from "
            f"torch.profiler "
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
        return (lambda: fa.flash_attention(q, k, v, causal=True, bq=bq,
                                           bkv=bkv),
                lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                                 bq=bq, bkv=bkv),
                sdpa_call(torch, q, k, v),
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
        kern, plain, lib, tols, (b_ms, b_by) = config_calls(
            torch, kernels, kmods, wl, tuned.config, inputs)
        ms = bench_ms(kern)
        plain_ms = bench_ms(plain, reps=2, warmup=1)
        lib_name = ""
        if kind == "attention":
            lib_ms, lib_name = sdpa_backends(torch, lib, kern(), tols,
                                             "[autotune] attention float32")
            lib_name = f" (SDPA {lib_name})"
        else:
            lib_ms = bench_ms(lib) if lib else None
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=lib_ms)
        log(f"[autotune] {kind} tuned config: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}{lib_name}, "
            f"bound {b_ms:.4f} ms ({b_by})")
        if kind == "attention":
            # bf16 yardstick at the tuned blocks (the main path runs f32)
            cfg16 = kb.KernelConfig("attention", tuned.config.block, "", 16)
            k16, p16, l16, tols16, (b16, by16) = config_calls(
                torch, kernels, kmods, wl, cfg16, inputs)
            l16_ms, l16_name = sdpa_backends(torch, l16, k16(), tols16,
                                             "[autotune] attention bf16")
            log(f"[autotune] attention bf16 at the tuned blocks: kernel "
                f"{bench_ms(k16):.4f} ms, plain "
                f"{bench_ms(p16, reps=2, warmup=1):.4f} ms, SDPA "
                f"{l16_ms:.4f} ms ({l16_name}), bound {b16:.4f} ms ({by16})")
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
    golden-parity gate between the batched and the ``0,0`` pass), each
    pass's derived values held to the committed anchors, the autotune
    cell's gates; the Spearman signs at the reference's shapes printed
    beside the TPU's."""
    from repro_torch.bench import run as bench_run
    from repro_torch.bench._compare import derived_equal
    from repro_torch.bench.common import fast_anchors
    with open(ROOT / "BENCH_mapper.json") as f:
        committed = json.load(f)["engines"]
    want = dict(fast_anchors(), **{
        bench: committed["batched"][bench]["derived"]
        for bench in ("fig7", "fig11", "fig13", "flexion", "service")})
    want = {bench: want[bench] for bench in BENCH_BENCHES}
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
    from repro_torch.bench import diff_bench
    missing = list(diff_bench.missing_required(doc))
    check(not missing, f"[bench] required metrics missing: {missing}")
    selfcheck = _port_module(["repro_torch.bench.diff_bench",
                              "--self-check"], 120)
    check(selfcheck.returncode == 0, f"[bench] diff_bench --self-check "
          f"exited {selfcheck.returncode}: {selfcheck.stderr[-2000:]}")
    log(f"[bench] diff_bench: {selfcheck.stdout.strip()}; no required "
        f"metric missing from {BENCH_JSON}")
    for label in ("batched", "campaign-d0,0"):
        cells = doc["engines"][label]
        for bench, anchor in want.items():
            check(derived_equal(cells[bench]["derived"], anchor,
                                rtol=ANCHOR_RTOL),
                  f"[bench] {label} {bench}: {cells[bench]['derived']} vs "
                  f"{anchor}")
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


def _src_env() -> dict:
    """This process's environment with the checkout's ``src`` first on
    ``PYTHONPATH``, for the processes the phases start."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                               else []))
    return env


def _port_module(args, timeout):
    """``python -m`` of a port module in a process of its own."""
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                          env=_src_env(), capture_output=True, text=True,
                          timeout=timeout)


class _LockRecorder:
    """(held, then-acquired) lock pairs every thread takes, through
    :meth:`wrap`'s proxies around the real locks.  A proxy has only
    ``acquire``/``release``, so a ``threading.Condition`` over it takes its
    plain-lock path, which goes through both."""

    def __init__(self):
        import threading
        self.edges, self.acquired = set(), set()
        self._tls, self._mu = threading.local(), threading.Lock()

    def _held(self) -> list:
        if not hasattr(self._tls, "held"):
            self._tls.held = []
        return self._tls.held

    def wrap(self, name: str, inner):
        rec = self

        class Proxy:
            def acquire(self, blocking=True, timeout=-1):
                got = inner.acquire(blocking, timeout)
                if got:
                    held = rec._held()
                    with rec._mu:
                        rec.acquired.add(name)
                        rec.edges.update((h, name) for h in held if h != name)
                    held.append(name)
                return got

            def release(self):
                held = rec._held()
                del held[len(held) - 1 - held[::-1].index(name)]
                inner.release()

            def __enter__(self):
                self.acquire()
                return self

            def __exit__(self, *exc):
                self.release()
                return False

        return Proxy()


def _lock_order_pass(torch, device):
    """A concurrent DSE service pass (ANALYSIS_CLIENTS clients) with the
    port's four real locks wrapped in recording proxies; the locks are put
    back after it.  Returns the recorder, the answers and the seconds."""
    import threading
    import types

    from repro_torch.core import flexion_batched as fb
    from repro_torch.core import workloads as wl
    from repro_torch.core.mapper import GAConfig
    from repro_torch.core.result_cache import ResultCache
    from repro_torch.core.spec import make_variant
    from repro_torch.kernels import _build
    from repro_torch.serve import dse_service
    rec = _LockRecorder()
    a = [wl.conv("a1", 16, 8, 14, 14, 3, 3),
         wl.conv("a2", 16, 8, 14, 14, 3, 3),
         wl.conv("a3", 32, 16, 7, 7, 1, 1)]
    b = [wl.conv("b1", 16, 8, 14, 14, 3, 3),
         wl.dwconv("b2", 16, 14, 14, 3, 3)]
    queries = [a, b, a[1:], b[:1]][:ANALYSIS_CLIENTS]
    spec, cfg = make_variant("1111"), GAConfig(population=8, generations=3,
                                               seed=0)
    saved = (fb._TABLE_LOCK, _build._LOCK, dse_service.threading)
    fb._TABLE_LOCK = rec.wrap(LOCK_IDS[0], threading.Lock())
    _build._LOCK = rec.wrap(LOCK_IDS[3], threading.Lock())
    dse_service.threading = types.SimpleNamespace(
        Lock=lambda: rec.wrap(LOCK_IDS[2], threading.Lock()),
        Condition=threading.Condition, Thread=threading.Thread,
        Event=threading.Event)
    answers, errs = [None] * len(queries), []
    try:
        cache = ResultCache()
        cache._lock = rec.wrap(LOCK_IDS[1], cache._lock)
        t0 = time.perf_counter()
        with dse_service.DSEService(cache=cache, device=device) as svc:
            def client(i):
                try:
                    answers[i] = svc.query(queries[i], spec, cfg,
                                           timeout=300)
                except BaseException as e:  # noqa: BLE001 - checked below
                    errs.append(e)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(queries))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            check(not any(th.is_alive() for th in threads),
                  "[analysis] service clients finished")
            svc.cache_stats()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        fb._TABLE_LOCK, _build._LOCK, dse_service.threading = saved
    check(not errs, f"[analysis] service clients raised {errs}")
    return rec, list(zip(queries, answers)), spec, cfg, seconds


def phase_analysis(torch, device):
    """The port's linter on this machine (no jax): exit 0, ok, every
    ``.py`` under src/repro_torch scanned, REP000-REP009 listed; then the
    lock orders a concurrent DSE service pass takes on the card, held to
    the static REP007 graph."""
    from repro_torch.analysis.locksets import lock_order_edges
    from repro_torch.analysis.walker import Project
    from repro_torch.core.mapper import search_campaign
    t0 = time.perf_counter()
    out = _port_module(["repro_torch.analysis", "--format", "json",
                        "--budget-seconds", str(LINT_BUDGET_S)],
                       timeout=4 * LINT_BUDGET_S)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"[analysis] the linter exited "
          f"{out.returncode}: {out.stdout[-3000:]} {out.stderr[-2000:]}")
    doc = json.loads(out.stdout)
    n_py = len(list((ROOT / "src" / "repro_torch").rglob("*.py")))
    check(doc["ok"] is True, "[analysis] lint ok")
    check(doc["files_scanned"] == n_py,
          f"[analysis] {doc['files_scanned']} files scanned of {n_py}")
    rules = _port_module(["repro_torch.analysis", "--list-rules"], 120)
    codes = [line.split()[0] for line in rules.stdout.splitlines()]
    check(rules.returncode == 0 and codes == list(LINT_CODES),
          f"[analysis] --list-rules gave {codes}")
    log(f"[analysis] lint: exit 0, ok, {doc['files_scanned']} files, "
        f"{doc['suppressed']} suppressed, {doc['elapsed_s']} s in the "
        f"linter ({wall:.2f} s with its process); rules "
        f"{codes[0]}-{codes[-1]}")

    import threading
    control = _LockRecorder()
    outer, inner = (control.wrap(n, threading.Lock()) for n in "ab")
    with outer, inner:
        pass
    check(control.edges == {("a", "b")}, "[analysis] the recorder's "
          f"control took a then b and recorded {control.edges}")
    t0 = time.perf_counter()
    static = lock_order_edges(Project.load(ROOT, ["src/repro_torch"]))
    static_s = time.perf_counter() - t0
    rec, answered, spec, cfg, seconds = _lock_order_pass(torch, device)
    for layers, got in answered:
        want = search_campaign([(layers, spec)], cfg, device=device)[0]
        check(got.edp == want.edp and got.runtime == want.runtime,
              "[analysis] a service answer equals its solo campaign")
    observed = {(x, y) for x, y in rec.edges
                if x in LOCK_IDS and y in LOCK_IDS}
    check(observed <= static, f"[analysis] runtime lock orders "
          f"{sorted(observed - static)} not in the static graph "
          f"{sorted(static)}")
    check(set(LOCK_IDS[:3]) <= rec.acquired,
          f"[analysis] recorded locks {sorted(rec.acquired)}")
    log(f"[analysis] lock orders: {len(answered)} clients on {device} in "
        f"{seconds:.2f} s, answers equal solo campaigns; taken "
        f"{sorted(observed)} <= static {sorted(static)} (static graph "
        f"{static_s:.2f} s); locks seen {sorted(rec.acquired)}")


def _floats(v):
    """Every float of a nested dict/list, in a fixed order."""
    if isinstance(v, dict):
        return [x for k in sorted(v) for x in _floats(v[k])]
    if isinstance(v, list):
        return [x for item in v for x in _floats(item)]
    return [v] if isinstance(v, float) else []


def phase_model(torch, device):
    """Every architecture at its smoke config on the card, float32, TF32
    off: params drawn by numpy in the reference's layout (their checksum
    first), converted, then forward logits, aux and loss, prefill and 3
    greedy decode steps held to anchors_smoke.json at MODEL_TOL."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.core.convert import numpy_params, params_from_numpy
    from repro_torch.models import anchors
    pinned = anchors.load()["archs"]
    for arch in sorted(ARCHS):
        t0 = time.perf_counter()
        cfg = get_config(arch, smoke=True)
        tree = numpy_params(cfg, anchors.PARAM_SEED)
        want = dict(pinned[arch])
        check(np.allclose(anchors.params_checksum(tree), want.pop("checksum"),
                          rtol=1e-12, atol=0),
              f"[model] {arch}: numpy drew other params than the anchors' "
              f"(numpy's stream changed), not a model fault")
        got = anchors.port_outputs(cfg, params_from_numpy(cfg, tree, device),
                                   device)
        bad = anchors.mismatches(got, want, MODEL_TOL, MODEL_TOL)
        check(not bad, f"[model] {arch} against anchors_smoke.json: {bad}")
        err = max(abs(a - b) for a, b in zip(_floats(got), _floats(want)))
        log(f"[model] {arch} ({cfg.block}): loss {got['loss']:.6f} (anchor "
            f"{want['loss']:.6f}), greedy tokens {got['tokens']} as pinned, "
            f"max |port - reference| {err:.3g} (tolerance {MODEL_TOL}); "
            f"{time.perf_counter() - t0:.2f} s")


def _to_float32(tree):
    if isinstance(tree, dict):
        return {k: _to_float32(v) for k, v in tree.items()}
    return tree.float()


def _greedy(torch, models, cfg, params, toks, steps, decode_ctx=None):
    """Prefill ``toks`` and decode ``steps`` greedy tokens, each part timed
    between CUDA events (``decode_ctx``, when given, wraps the decode loop):
    the prefill logits, the tokens, prefill ms and decode ms a step."""
    b, s = toks.shape
    start, mid, end = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
    with torch.inference_mode():
        cache = models.init_cache(cfg, b, s + steps, toks.device)
        start.record()
        first, cache = models.prefill(cfg, params, {"tokens": toks}, cache)
        mid.record()
        logits, out = first, []
        with decode_ctx or contextlib.nullcontext():
            for _ in range(steps):
                nxt = torch.argmax(logits, -1)
                out.append(nxt)
                logits, cache = models.decode_step(cfg, params, nxt[:, None],
                                                   cache)
            end.record()
            end.synchronize()
    return (first, torch.stack(out, 1), start.elapsed_time(mid),
            mid.elapsed_time(end) / steps)


def _serve_prompts(torch, cfg, rng, device):
    return torch.as_tensor(rng.integers(1, cfg.vocab, (SERVE_BATCH,
                                                        SERVE_PROMPT)),
                           device=device)


def phase_serve(torch, device):
    """gemma-2b at its published widths and depth (18 layers, d_model 2048,
    MQA, d_ff 16384, vocab 256000), bfloat16, served by
    ``launch.serve.run_serving`` as a user calls it; prefill and decode
    timed (medians of SERVE_RUNS runs); then on the same params in float32: prefill == forward,
    prefill + decode == teacher forcing, and a FLASH_LEN-token prefill
    through the flash twin == dense attention.  The bf16 run's error
    against float32 and its greedy agreement are findings, not gates."""
    import re

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import attention

    cfg = get_config(SERVE_ARCH)
    check(cfg.dtype == "bfloat16" and cfg.n_layers == 18, f"{cfg}")
    torch.cuda.reset_peak_memory_stats()
    lines = []
    t0 = time.perf_counter()
    results = launch_serve.run_serving(
        SERVE_ARCH, smoke=False, n_requests=SERVE_REQUESTS,
        max_new=SERVE_NEW, max_batch=SERVE_BATCH, seed=0,
        print_fn=lines.append, device=device)
    wall = time.perf_counter() - t0
    check([r.uid for r in results] == list(range(SERVE_REQUESTS))
          and all(r.error is None and len(r.tokens) == SERVE_NEW
                  and ((r.tokens >= 0) & (r.tokens < cfg.vocab)).all()
                  for r in results),
          f"[serve] every request answered with {SERVE_NEW} tokens")
    tok_s = float(re.search(r"\(([0-9.]+) tok/s\)", lines[0]).group(1))
    peak_serve = torch.cuda.max_memory_allocated() / 1e9
    for line in lines:
        log(f"[serve] {line}")
    log(f"[serve] {SERVE_ARCH} bf16, {cfg.param_count() / 1e9:.2f} B "
        f"params: {SERVE_REQUESTS} requests in waves of {SERVE_BATCH}, "
        f"{tok_s} tok/s (launcher's clock), {wall:.2f} s with the param "
        f"draw; peak {peak_serve:.2f} GB")

    # run_serving keeps the reference's signature and returns only the
    # results, so the checks redraw its params from the same seed
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = models.init_params(cfg, gen, device)
    rng = np.random.default_rng(0)
    toks = _serve_prompts(torch, cfg, rng, device)
    # the step is host-bound and the host's pace varies from run to run:
    # the median of SERVE_RUNS runs after a warm-up
    runs = [_greedy(torch, models, cfg, params, toks, SERVE_NEW)[2:]
            for _ in range(SERVE_RUNS + 1)][1:]
    pre_ms, dec_ms = (float(np.median(r)) for r in zip(*runs))
    dec = sorted(r[1] for r in runs)
    log(f"[serve] bf16 prefill {SERVE_BATCH}x{SERVE_PROMPT} tokens "
        f"{pre_ms:.2f} ms; decode {dec_ms:.2f} ms a step at batch "
        f"{SERVE_BATCH} ({SERVE_BATCH * 1e3 / dec_ms:.1f} tok/s; medians of "
        f"{SERVE_RUNS} runs, decode {dec[0]:.2f}-{dec[-1]:.2f}); decode "
        f"byte bound {cfg.param_count() * 2 / HBM_BYTES_PER_S * 1e3:.2f} ms "
        f"(the bf16 params read once)")

    cfg32 = cfg.replace(dtype="float32")
    p32 = _to_float32(params)
    with torch.inference_mode():
        # prefill's last-token logits == forward's
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)),
                               device=device)
        cache = models.init_cache(cfg32, 2, 24, device)
        last, _ = models.prefill(cfg32, p32, {"tokens": toks}, cache)
        full, _ = models.forward(cfg32, p32, {"tokens": toks})
        err = max_err(last, full[:, -1])
        torch.testing.assert_close(last, full[:, -1], rtol=FORWARD_TOL,
                                   atol=FORWARD_TOL)
        log(f"[serve] float32 prefill == forward: max err {err:.3g} "
            f"(tolerance {FORWARD_TOL})")
        # prefill of 6 tokens + 6 decode steps == teacher forcing
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 12)),
                               device=device)
        full, _ = models.forward(cfg32, p32, {"tokens": toks})
        cache = models.init_cache(cfg32, 1, 14, device)
        logits, cache = models.prefill(cfg32, p32, {"tokens": toks[:, :6]},
                                       cache)
        errs = [max_err(logits, full[:, 5])]
        torch.testing.assert_close(logits, full[:, 5], rtol=TEACHER_TOL,
                                   atol=TEACHER_TOL)
        for t in range(6, 12):
            logits, cache = models.decode_step(cfg32, p32, toks[:, t:t + 1],
                                               cache)
            errs.append(max_err(logits, full[:, t]))
            torch.testing.assert_close(logits, full[:, t], rtol=TEACHER_TOL,
                                       atol=TEACHER_TOL)
        log(f"[serve] float32 prefill(6) + decode(6) == teacher forcing: "
            f"max err {max(errs):.3g} (tolerance {TEACHER_TOL})")
        del full
        # a long prefill: 'auto' sends it through the flash twin
        calls = []
        twin = attention._flash_attention_jnp

        def counted(*a, **k):
            calls.append(1)
            return twin(*a, **k)

        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, FLASH_LEN)),
                               device=device)
        attention._flash_attention_jnp = counted
        try:
            t0 = time.perf_counter()
            flash, _ = models.prefill(
                cfg32, p32, {"tokens": toks},
                models.init_cache(cfg32, 1, FLASH_LEN, device))
            torch.cuda.synchronize()
            t_flash = time.perf_counter() - t0
        finally:
            attention._flash_attention_jnp = twin
        check(len(calls) == cfg.n_layers,
              f"[serve] 'auto' took the flash twin in {len(calls)} of "
              f"{cfg.n_layers} layers at {FLASH_LEN} tokens")
        t0 = time.perf_counter()
        dense_cfg = cfg32.replace(attn_impl="dense")
        dense, _ = models.prefill(
            dense_cfg, p32, {"tokens": toks},
            models.init_cache(dense_cfg, 1, FLASH_LEN, device))
        torch.cuda.synchronize()
        t_dense = time.perf_counter() - t0
        err = max_err(flash, dense)
        torch.testing.assert_close(flash, dense, rtol=FORWARD_TOL,
                                   atol=FORWARD_TOL)
        log(f"[serve] float32 prefill of {FLASH_LEN} tokens, flash twin "
            f"(block {cfg.attn_block_kv}) == dense: max err {err:.3g} "
            f"(tolerance {FORWARD_TOL}); {t_flash * 1e3:.1f} / "
            f"{t_dense * 1e3:.1f} ms (host clock, first call each)")
        del flash, dense
        # findings: bf16 against float32 on the same prompts
        toks = _serve_prompts(torch, cfg, rng, device)
        l16, t16, *_ = _greedy(torch, models, cfg, params, toks, SERVE_NEW)
        l32, t32, *_ = _greedy(torch, models, cfg32, p32, toks, SERVE_NEW)
        first = (t16[:, 0] == t32[:, 0]).float().mean().item()
        agree = (t16 == t32).float().mean().item()
        log(f"[serve] finding: bf16 prefill logits against float32 max err "
            f"{max_err(l16, l32):.3g} (|logit| up to "
            f"{l32.abs().max().item():.3g}); greedy tokens agree "
            f"{agree:.3f} over {SERVE_NEW} steps, first token {first:.3f}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[serve] peak device memory {peak:.2f} GB (bf16 params, a float32 "
        f"copy and the {FLASH_LEN}-token prefill)")
    del p32
    return cfg, params, dec_ms


def phase_train(torch, device):
    """Every architecture at its smoke config trained on the card, float32,
    TF32 off, held to anchors_train_smoke.json (gradients, default-optimizer
    steps, an SGD step in two microbatches); then the restart check:
    ``run_training`` of RESTART_ARCH with a fault at RESTART_FAIL_AT ends at
    its last step after one restart, its loss falls, and its final
    checkpoint equals a fault-free run's file for file, byte for byte."""
    import filecmp
    import tempfile

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.core.convert import numpy_params
    from repro_torch.launch.train import run_training
    from repro_torch.models import anchors
    from repro_torch.models import train_anchors as TA
    pinned = TA.load()["archs"]
    checksums = anchors.load()["archs"]
    for arch in sorted(ARCHS):
        t0 = time.perf_counter()
        cfg = get_config(arch, smoke=True)
        tree = numpy_params(cfg, TA.PARAM_SEED)
        check(np.allclose(anchors.params_checksum(tree),
                          checksums[arch]["checksum"], rtol=1e-12, atol=0),
              f"[train] {arch}: numpy drew other params than the anchors' "
              f"(numpy's stream changed), not a model fault")
        got = TA.port_outputs(cfg, tree, device)
        bad, share = TA.compare(got, pinned[arch])
        check(not bad, f"[train] {arch} against anchors_train_smoke.json: "
                       f"{bad}")
        losses = ", ".join(f"{x:.6f}" for x in got["train"]["losses"])
        log(f"[train] {arch} ({cfg.block}): loss {got['loss']:.6f}, "
            f"{len(got['grads'])} grad leaves, default-optimizer steps' "
            f"losses {losses}, grad-accum loss {got['accum']['loss']:.6f}; "
            f"the worst difference from the anchors {share:.3g} of its "
            f"tolerance; {time.perf_counter() - t0:.2f} s")

    with tempfile.TemporaryDirectory() as tmp:
        runs, lines = {}, []
        for name, fail_at in (("fault", RESTART_FAIL_AT), ("clean", ())):
            t0 = time.perf_counter()
            runs[name] = run_training(
                RESTART_ARCH, ckpt_dir=os.path.join(tmp, name),
                fail_at=fail_at, print_fn=lines.append, device=device,
                **RESTART_RUN)
            runs[name + " s"] = time.perf_counter() - t0
        res, clean = runs["fault"], runs["clean"]
        losses = [m["loss"] for m in res.metrics_history]
        steps = RESTART_RUN["steps"]
        check(res.final_step == steps and res.restarts == 1
              and losses[-1] < losses[0],
              f"[train] restart run: step {res.final_step}, "
              f"{res.restarts} restarts, loss {losses[0]} -> {losses[-1]}")
        check(res.metrics_history == clean.metrics_history,
              "[train] the restarted run's history == the fault-free run's")
        final = [os.path.join(tmp, name, f"step_{steps}")
                 for name in ("fault", "clean")]
        files = sorted(os.listdir(final[1]))
        same = [f for f in files
                if filecmp.cmp(os.path.join(final[0], f),
                               os.path.join(final[1], f), shallow=False)]
        check(sorted(os.listdir(final[0])) == files and same == files,
              f"[train] final checkpoints equal bit for bit: "
              f"{sorted(set(files) - set(same))} differ")
    log(f"[train] {RESTART_ARCH} smoke through run_training, {steps} "
        f"steps, fault at {RESTART_FAIL_AT}, checkpoints every "
        f"{RESTART_RUN['ckpt_every']}: 1 restart, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, history == the fault-free run's, final "
        f"checkpoint == the fault-free run's in all {len(files)} files, "
        f"bit for bit; {runs['fault s']:.2f} / {runs['clean s']:.2f} s")
    for line in lines:
        log(f"[train]   {line}")


def _fwd_bwd(torch, cfg, params, batch):
    """One forward and backward of the loss, timed between CUDA events:
    the loss, the grads in leaf order, ms, the peak device memory above
    what was allocated before (GB), and the host's ms until autograd
    returns (where it is close to ms, the host's dispatch sets the
    pace)."""
    from repro_torch.models import loss_fn
    from repro_torch.tree import leaves
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    t0 = time.perf_counter()
    total, m = loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(total, flat)
    host = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    peak = (torch.cuda.max_memory_allocated() - before) / 1e9
    return m["loss"].item(), grads, start.elapsed_time(end), peak, host


def _grad_gap(torch, names, got, want):
    """(leaves not bit-equal, the largest |got - want| over a leaf's
    largest |want|)."""
    unequal = [n for n, a, b in zip(names, got, want)
               if not torch.equal(a, b)]
    worst = max(max_err(a, b) / max(float(b.float().abs().max()), 1e-30)
                for a, b in zip(got, want))
    return unequal, worst


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _host_available() -> float:
    """The host's available memory in bytes (/proc/meminfo)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return float(line.split()[1]) * 1024
    return float("nan")


def phase_train_full(torch, device):
    """gemma-2b at its published widths and depth (18 layers, d_model 2048,
    MQA, d_ff 16384, vocab 256000), bfloat16, remat on, batch TRAIN_BATCH x
    TRAIN_SEQ: (1) remat on and off give the same gradients on one batch,
    and unbinding the stacked leaves against taking a layer at a time, each
    timed; (2) ``run_training`` for TRAIN_STEPS steps as a user calls it,
    its checkpoint only at the end, written into a temporary directory;
    (3) that checkpoint restored onto the card and TRAIN_MORE more steps of
    ``make_train_step`` timed between CUDA events, beside MFU and the
    AdamW update's byte bound."""
    import re
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import checkpoint as ckpt_mod
    from repro_torch.configs import get_config
    from repro_torch.data import make_dataset
    from repro_torch.launch import steps
    from repro_torch.launch.train import run_training
    from repro_torch.models import init_params, transformer
    from repro_torch.optim import sgd
    from repro_torch.tree import leaves, named_leaves, unflatten

    cfg = get_config(TRAIN_ARCH)
    check(cfg.dtype == "bfloat16" and cfg.remat and cfg.n_layers == 18,
          f"{cfg}")
    ds = make_dataset(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      seed=0)

    def on_card(step):
        return {k: torch.as_tensor(v, device=device)
                for k, v in ds.batch_at(step).items()}

    # (1) remat on / off, unbound / selected layers: one batch, same params
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device)
    named = named_leaves(params)
    n_params = sum(p.numel() for _, p in named)
    n_stack = sum(p.numel() for n, p in named if n.startswith("stack/"))
    batch = on_card(0)
    _fwd_bwd(torch, cfg, params, batch)                      # warm-up
    loss_on, g_on, ms_on, peak_on, _ = _fwd_bwd(torch, cfg, params, batch)
    loss_off, g_off, ms_off, peak_off, _ = _fwd_bwd(
        torch, cfg.replace(remat=False), params, batch)
    names = [n for n, _ in named]
    unequal, gap = _grad_gap(torch, names, g_on, g_off)
    check(loss_on == loss_off and gap <= 2.0 ** -7,
          f"[train full] remat on == off: loss {loss_on} / {loss_off}, "
          f"grads {gap:.3g} of a leaf's largest")
    log(f"[train full] {TRAIN_ARCH} bf16, {n_params / 1e9:.3f} B params, "
        f"batch {TRAIN_BATCH}x{TRAIN_SEQ}: remat on and off, loss "
        f"{loss_on:.4f} both; grads "
        + ("bit-equal in all " + str(len(names)) + " leaves" if not unequal
           else f"not bit-equal in {unequal} (largest gap {gap:.3g} of the "
                f"leaf's largest |g|)")
        + f"; forward + backward {ms_on:.1f} ms and {peak_on:.2f} GB above "
        f"the params with remat, {ms_off:.1f} ms and {peak_off:.2f} GB "
        f"without")
    del g_off
    unstack = transformer._unstack
    transformer._unstack = lambda tree, n: [transformer._layer(tree, i)
                                            for i in range(n)]
    try:
        loss_sel, g_sel, ms_sel, peak_sel, _ = _fwd_bwd(torch, cfg, params,
                                                        batch)
    finally:
        transformer._unstack = unstack
    unequal_sel, gap_sel = _grad_gap(torch, names, g_sel, g_on)
    check(loss_sel == loss_on and gap_sel <= 2.0 ** -7,
          f"[train full] layer a time == unbound: {gap_sel:.3g}")
    log(f"[train full] stacked leaves with remat: unbound once a forward "
        f"{ms_on:.1f} ms, {peak_on:.2f} GB; a layer at a time (tree[i], "
        f"whose backward writes a zero stack a layer) {ms_sel:.1f} ms, "
        f"{peak_sel:.2f} GB; grads "
        + ("bit-equal" if not unequal_sel else f"differ in {unequal_sel}"))
    # ``named`` holds the leaves too: without it 5 GB of params stay
    del g_on, g_sel, params, named, batch
    torch.cuda.empty_cache()

    # (2) run_training as a user calls it; the checkpoint only at the end
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        disk = shutil.disk_usage(tmp).free
        ram = _host_available()
        need = n_params * (2 + 8)            # bf16 params, AdamW m and v
        optimizer = "auto" if min(disk, ram) > 1.5 * need else "sgd"
        log(f"[train full] checkpoint directory {tmp}: {disk / 1e9:.1f} GB "
            f"free on its disk, {ram / 1e9:.1f} GB of host memory "
            f"available; an AdamW state takes {need / 1e9:.2f} GB, so "
            f"optimizer={optimizer!r}"
            + ("" if optimizer == "auto" else
               " (the machine cannot hold an AdamW checkpoint and its host "
               "copies with room to spare)"))
        saves, save_state = [], ckpt_mod.save_state

        def timed_save(ckpt_dir, step, state, blocking=True):
            t0 = time.perf_counter()
            save_state(ckpt_dir, step, state, blocking=True)
            saves.append((step, time.perf_counter() - t0))

        ckpt_mod.save_state = timed_save
        lines = []
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            res = run_training(TRAIN_ARCH, smoke=False, steps=TRAIN_STEPS,
                               batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                               optimizer=optimizer, log_every=1,
                               ckpt_dir=tmp, ckpt_every=TRAIN_STEPS + 1,
                               print_fn=lines.append, device=device)
            wall = time.perf_counter() - t0
        finally:
            ckpt_mod.save_state = save_state
        peak = torch.cuda.max_memory_allocated() / 1e9
        for line in lines:
            log(f"[train full]   {line}")
        losses = [m["loss"] for m in res.metrics_history]
        check(res.final_step == TRAIN_STEPS and res.restarts == 0
              and all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"[train full] run_training: losses {losses}")
        tok_s = float(re.search(r"([0-9.]+) tok/s", lines[-1]).group(1))
        (step, save_s), = saves
        size = _dir_bytes(os.path.join(tmp, f"step_{step}"))
        log(f"[train full] run_training({TRAIN_ARCH!r}, smoke=False, "
            f"steps={TRAIN_STEPS}, optimizer={optimizer!r}): loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}, {tok_s} tok/s (the "
            f"launcher's host clock, the first step's warm-up included), "
            f"{wall:.1f} s in all; peak device memory {peak:.2f} GB; the "
            f"step-{step} checkpoint {size / 1e9:.2f} GB written in "
            f"{save_s:.1f} s ({size / 1e9 / save_s:.2f} GB/s, the host "
            f"copies included), {disk / 1e9:.1f} GB free before it")

        # (3) the checkpoint restored onto the card, more steps timed
        opt = (steps.default_optimizer(cfg) if optimizer == "auto"
               else sgd(3e-4))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, at = CheckpointManager(tmp).restore(
            steps.state_specs(cfg, opt), device)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(at == TRAIN_STEPS and int(state.step) == TRAIN_STEPS
              and all(x.device.type == torch.device(device).type
                      for x in leaves(state)),
              f"[train full] restored step {at} / {int(state.step)}")
        step_fn = steps.make_train_step(cfg, opt)
        times, more = [], []
        for s in range(TRAIN_STEPS, TRAIN_STEPS + TRAIN_MORE):
            batch = on_card(s)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            state, m = step_fn(state, batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            more.append(m["loss"].item())
        check(all(np.isfinite(more)) and int(state.step) == TRAIN_STEPS
              + TRAIN_MORE, f"[train full] after the restore: {more}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        # one more step split in two: forward + backward, then the update
        _, grads, fb_ms, *_ = _fwd_bwd(torch, cfg, state.params,
                                       on_card(TRAIN_STEPS + TRAIN_MORE))
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        opt.update(unflatten(state.params, list(grads)), state.opt,
                   state.params, state.step)
        end.record()
        end.synchronize()
        update_ms = start.elapsed_time(end)
        del state, grads
        tokens = TRAIN_BATCH * TRAIN_SEQ
        flops = 6 * n_params * tokens + 2 * n_stack * tokens
        ms = float(np.mean(times))
        bound = n_params * UPDATE_BYTES[optimizer] / HBM_BYTES_PER_S * 1e3
        log(f"[train full] restored step {at} onto the card in "
            f"{restore_s:.1f} s ({size / 1e9 / restore_s:.2f} GB/s); "
            f"{TRAIN_MORE} more steps of make_train_step, losses "
            + ", ".join(f"{x:.4f}" for x in more)
            + f": " + " / ".join(f"{t:.1f}" for t in times)
            + f" ms (CUDA events), mean {ms:.1f} ms, "
            f"{tokens * 1e3 / ms:.0f} tok/s; MFU "
            f"{flops / (ms * 1e-3) / PEAK_OPS['bfloat16']:.3f}"
            f" (6 N T + 2 N_stack T = {flops:.3e} FLOP a step, the remat "
            f"replay included, over 989 TFLOP/s bf16); the "
            f"{'AdamW' if optimizer == 'auto' else 'SGD'} update's byte "
            f"bound {bound:.1f} ms ({UPDATE_BYTES[optimizer]} B a param at "
            f"3.35 TB/s); a fourth step split: forward + backward "
            f"{fb_ms:.1f} ms, the update {update_ms:.1f} ms "
            f"({update_ms / bound:.1f}x its bound); "
            f"peak device memory {peak:.2f} GB")
        return dict(step_ms=ms, optimizer=optimizer, fb_ms=ms_on,
                    fb_gb=peak_on, loss=loss_on)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _leaf_share(torch, got, want) -> float:
    """The largest |got - want| of any leaf over that leaf's largest
    |want|."""
    from repro_torch.tree import leaves
    return max(max_err(a, b) / max(float(b.float().abs().max()), 1e-30)
               for a, b in zip(leaves(got), leaves(want)))


def _open_group(torch, device, tmp):
    """A process group of world size 1 from a FileStore in ``tmp``: NCCL
    on the card, gloo on the CPU (the rehearsal)."""
    import torch.distributed as dist
    store = dist.FileStore(os.path.join(tmp, "store"), 1)
    if device == "cpu":
        dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    else:
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=torch.device(device, 0))


def _dist_smoke_arch(torch, device, mesh, arch):
    """One smoke arch on the 1x1 mesh against the one-device steps:
    2 default-optimizer train steps with FSDP off and on (worst loss gap
    relative, worst param gap as a share of the leaf's largest), then a
    prefill and 3 decode steps (worst logits gap)."""
    from repro_torch.configs import get_config
    from repro_torch.core.convert import numpy_params, params_from_numpy
    from repro_torch.dist import gather_tree
    from repro_torch.launch import steps as S
    from repro_torch.models import anchors, decode_step, init_cache, prefill

    loss_gap = param_gap = logit_gap = 0.0
    base = get_config(arch, smoke=True)
    tree = numpy_params(base, 0)
    for fsdp in (False, True):
        cfg = base.replace(fsdp=fsdp)
        opt = S.default_optimizer(cfg)
        batches = [{k: torch.as_tensor(v, device=device) for k, v in
                    anchors.smoke_batch(cfg, DIST_BATCH, DIST_SEQ,
                                        seed).items()}
                   for seed in (1, 2)]
        fn, _, _ = S.jit_train_step(cfg, opt, mesh, batches[0])
        one = S.make_train_step(cfg, opt)
        states = [S.TrainState(p, opt.init(p), torch.zeros(
            (), dtype=torch.int32, device=device)) for p in (
            params_from_numpy(cfg, tree, device) for _ in range(2))]
        for b in batches:
            states[0], m0 = fn(states[0], b)
            states[1], m1 = one(states[1], b)
            loss_gap = max(loss_gap, abs(float(m0["loss"])
                                         - float(m1["loss"]))
                           / abs(float(m1["loss"])))
        param_gap = max(param_gap, _leaf_share(
            torch, gather_tree(states[0].params), states[1].params))
        del states
    params = params_from_numpy(base, tree, device)
    prompt = anchors.smoke_batch(base, DIST_BATCH, DIST_SEQ, 3)
    prompt = {k: torch.as_tensor(v, device=device)
              for k, v in prompt.items() if k != "labels"}
    pf, _, _ = S.jit_prefill_step(base, mesh, prompt, DIST_BATCH,
                                  DIST_SEQ + DIST_DECODE)
    sv, _, _ = S.jit_serve_step(base, mesh, DIST_BATCH,
                                DIST_SEQ + DIST_DECODE)
    new = lambda: init_cache(base, DIST_BATCH,  # noqa: E731
                             DIST_SEQ + DIST_DECODE, device)
    got, cache = pf(params, prompt, new())
    want, ref_cache = prefill(base, params, prompt, new())
    pairs = [(got.full_tensor(), want)]
    for _ in range(DIST_DECODE):
        tok = want.argmax(-1, keepdim=True)
        got, cache = sv(params, tok, cache)
        want, ref_cache = decode_step(base, params, tok, ref_cache)
        pairs.append((got.full_tensor(), want))
    logit_gap = max(max_err(a, b) for a, b in pairs)
    return loss_gap, param_gap, logit_gap


def phase_dist(torch, device, one=None):
    """Main path 7, sharded training and serving through the distribution
    layer on a ('data', 'model') mesh of (1, 1) over a process group of
    world size 1 (NCCL, from a FileStore in a temporary directory):
    (1) every smoke arch's ``jit_train_step`` (2 default-optimizer steps,
    FSDP off and on), ``jit_prefill_step`` and 3 ``jit_serve_step`` steps
    against the one-device steps; (2) gemma-2b at its published widths and
    depth, bf16, remat on, FSDP on, trained DIST_STEPS steps through
    ``run_training`` with the group open (a ``torchrun --nproc-per-node 1``
    launch): each step timed between CUDA events and on the host clock
    until it returns, tok/s, peak memory, and the gap to ``[train full]``'s
    one-device steps; (3) one forward + backward from ``[train full]``'s
    params and batch, on one device and on the mesh, of the same leaves
    (the 1x1 mesh's local tensors are the whole leaves): the losses equal,
    ms (CUDA events), the host's ms until autograd returns, and GB.
    ``one`` is what ``phase_train_full`` returned.  The group is destroyed
    and the allocator emptied at the end."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.data import make_dataset
    from repro_torch.dist import (axis_rules, distribute_tree, make_rules,
                                  param_shardings)
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import run_training
    from repro_torch.models import init_params
    from repro_torch.tree import map_leaves

    one = one or {}
    optimizer = one.get("optimizer", "auto")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    _open_group(torch, device, tmp)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device)
        worst = [0.0, 0.0, 0.0]
        for arch in sorted(ARCHS):
            t0 = time.perf_counter()
            gaps = _dist_smoke_arch(torch, device, mesh, arch)
            check(gaps[0] <= DIST_LOSS_RTOL and gaps[1] <= DIST_PARAM_TOL
                  and gaps[2] <= DIST_LOGIT_ATOL,
                  f"[dist] {arch} on the 1x1 mesh == one device: {gaps}")
            worst = [max(w, g) for w, g in zip(worst, gaps)]
            log(f"[dist] {arch}: 1x1 mesh against one device, loss "
                f"{gaps[0]:.3g} (relative), params {gaps[1]:.3g} (of a "
                f"leaf's largest), logits {gaps[2]:.3g}"
                + (" (bit for bit)" if not any(gaps) else "")
                + f"; {time.perf_counter() - t0:.2f} s")
        log(f"[dist] {len(ARCHS)} smoke archs: worst loss {worst[0]:.3g}, "
            f"params {worst[1]:.3g}, logits {worst[2]:.3g} (allowed "
            f"{DIST_LOSS_RTOL}, {DIST_PARAM_TOL}, {DIST_LOGIT_ATOL})")

        # (2) full width through run_training, each step timed
        times, host, build = [], [], S.jit_train_step

        def timed_builder(*a, **k):
            fn, *rest = build(*a, **k)

            def timed(state, batch):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                t0 = time.perf_counter()
                out = fn(state, batch)
                host.append((time.perf_counter() - t0) * 1e3)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
                return out
            return (timed, *rest)

        S.jit_train_step = timed_builder
        lines = []
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            res = run_training(
                TRAIN_ARCH, smoke=False, steps=DIST_STEPS,
                batch=TRAIN_BATCH, seq=TRAIN_SEQ, optimizer=optimizer,
                log_every=1, ckpt_dir=os.path.join(tmp, "ckpt"),
                ckpt_every=DIST_STEPS + 1, config_overrides={"fsdp": True},
                print_fn=lines.append, device=device)
            wall = time.perf_counter() - t0
        finally:
            S.jit_train_step = build
        peak = torch.cuda.max_memory_allocated() / 1e9
        for line in lines:
            log(f"[dist]   {line}")
        losses = [m["loss"] for m in res.metrics_history]
        check(res.final_step == DIST_STEPS and len(times) == DIST_STEPS
              and all(np.isfinite(losses)) and "mesh (1, 1)" in lines[-1],
              f"[dist] run_training on the mesh: {losses}, {lines[-1:]}")
        steady = float(np.mean(times[1:]))
        tokens = TRAIN_BATCH * TRAIN_SEQ
        one_ms = one.get("step_ms")
        log(f"[dist] run_training({TRAIN_ARCH!r}, smoke=False, fsdp=True, "
            f"optimizer={optimizer!r}) on the 1x1 mesh: loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}; steps "
            + " / ".join(f"{t:.1f}" for t in times)
            + " ms (CUDA events; the first builds DTensor's sharding "
            "caches), the host's call returning after "
            + " / ".join(f"{t:.1f}" for t in host)
            + f" ms; {steady:.1f} ms a step after the first, "
            f"{tokens * 1e3 / steady:.0f} tok/s; peak device memory "
            f"{peak:.2f} GB; {wall:.1f} s with the final checkpoint"
            + ("" if one_ms is None else
               f"; [train full]'s one-device step {one_ms:.1f} ms, so the "
               f"mesh costs {steady - one_ms:+.1f} ms a step "
               f"({100 * (steady - one_ms) / one_ms:+.1f}%)"))

        # (3) forward + backward alone, on one device and on the 1x1 mesh,
        # of the same leaves: [train full]'s params and batch
        cfg = get_config(TRAIN_ARCH).replace(fsdp=True)
        rules = make_rules(mesh, fsdp=True)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = init_params(cfg, gen, device)
        params = distribute_tree(params, param_shardings(cfg, params, mesh,
                                                         rules))
        whole = map_leaves(lambda x: x.to_local().detach(), params)
        ds = make_dataset(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                          seed=0)
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in ds.batch_at(0).items()}

        @contextlib.contextmanager
        def on_mesh():
            with axis_rules(mesh, rules), implicit_replication():
                yield

        fb = []
        for tree, ctx in ((whole, contextlib.nullcontext), (params, on_mesh)):
            with ctx():
                _fwd_bwd(torch, cfg, tree, batch)            # warm-up
                loss, grads, ms, gb, host = _fwd_bwd(torch, cfg, tree, batch)
                del grads
                fb.append((loss, ms, host, gb))
        del params, whole
        (l1, ms1, host1, gb1), (lm, msm, hostm, gbm) = fb
        check(lm == l1 and one.get("loss", l1) == l1,
              f"[dist] full-width loss on the 1x1 mesh {lm} == one "
              f"device's {l1} (and [train full]'s {one.get('loss')})")
        log(f"[dist] {TRAIN_ARCH} forward + backward (remat on) of the same "
            f"leaves, loss {lm:.4f} on both, bit for bit: one device "
            f"{ms1:.1f} ms (CUDA events), its host call back after "
            f"{host1:.1f} ms, {gb1:.2f} GB above the params; the 1x1 mesh "
            f"(FSDP rules, DTensors) {msm:.1f} ms, host {hostm:.1f} ms, "
            f"{gbm:.2f} GB: {msm - ms1:+.1f} ms")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
        # hand the next phase an empty allocator, as [train full] does
        gc.collect()
        torch.cuda.empty_cache()


def _dryrun_proc(device_type, args, out=None, code=None):
    """The port's dry-run in a process of its own (its fake process group
    must not meet this process's), its fake tensors on ``device_type``."""
    cmd = ([sys.executable, "-c", code] if code is not None else
           [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
            "--device", device_type, "--out", str(out)])
    return subprocess.Popen(cmd, cwd=ROOT, env=_src_env(),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _dryrun_wait(proc, what: str) -> str:
    try:
        stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        check(False, f"[dryrun] {what}: no result in {DRYRUN_TIMEOUT} s")
    check(proc.returncode == 0, f"[dryrun] {what} exited {proc.returncode}:"
          f"\n{stdout[-2000:]}\n{stderr[-3000:]}")
    return stdout


def _last_record(path: Path) -> dict:
    return json.loads(path.read_text().strip().splitlines()[-1])


def _train_full_code(device) -> str:
    """The [train full] configuration's dry-run on a (1, 1) mesh, its
    record printed as JSON."""
    return (f"import json\n"
            f"from repro_torch.configs.shapes import ShapeCfg\n"
            f"from repro_torch.launch.dryrun import run_cell\n"
            f"rec = run_cell({TRAIN_ARCH!r}, ShapeCfg('train_full', 'train', "
            f"{TRAIN_SEQ}, {TRAIN_BATCH}), False, verbose=False, "
            f"mesh_shape=(1, 1), device={device!r})\n"
            f"print(json.dumps(rec))\n")


def _real_train_step(torch, device):
    """One gemma-2b step of ``make_train_step`` at [train full]'s
    configuration (bf16, remat on, AdamW, batch TRAIN_BATCH x TRAIN_SEQ) on
    the card: the state and batch bytes, the step's FLOPs counted by
    ``FlopCounterMode``, then one step timed (CUDA events) with its peak
    memory above what the process held before the state was made."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.data import make_dataset
    from repro_torch.launch import steps
    from repro_torch.models import init_params
    from repro_torch.tree import leaves

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    cfg = get_config(TRAIN_ARCH)
    opt = steps.default_optimizer(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device)
    state = steps.TrainState(params, opt.init(params),
                             torch.zeros((), dtype=torch.int32,
                                         device=device))
    ds = make_dataset(cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                      seed=0)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in ds.batch_at(0).items()}
    arg_bytes = sum(x.numel() * x.element_size()
                    for x in leaves(state) + list(batch.values()))
    step = steps.make_train_step(cfg, opt)
    with FlopCounterMode(display=False) as counter:
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    state, m = step(state, batch)
    end.record()
    end.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    check(np.isfinite(m["loss"].item()), "[dryrun] the real step's loss")
    del state, params, batch, m
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arg_bytes=arg_bytes, flops=counter.get_total_flops(),
                ms=start.elapsed_time(end), peak=peak)


def phase_dryrun(torch, device, train_full=None):
    """Main path 8, the dry-run group, which runs on fake tensors and
    launches no kernel: (1) gemma-2b x train_4k on the 16x16 fake mesh
    through ``python -m repro_torch.launch.dryrun`` (status ok; per-device
    memory and the three roofline terms); (2) the [train full]
    configuration dry-run on a (1, 1) mesh against one real step on the
    card: argument bytes equal to the real state's and batch's, the fake
    FLOP count equal to ``FlopCounterMode``'s over the real step, the
    predicted peak within DRYRUN_PEAK_BAND of the measured one, and the
    measured step beside the predicted ``bound_s``; (3) bridge_validation
    §1's pair written to results/perf_iters.jsonl and read by the port's
    bridge_validation (records_available, and the 1x256 mesh's memory term
    under a quarter of 16x16's: long_decode_remesh_agrees); (4) the BENCH
    writer's ``roofline`` pass over part 1's records; (5) DRYRUN_CELLS on
    the 16x16 fake mesh, each at status ok.  The production cell's peak
    must be under DRYRUN_PEAK_LIMIT.  The dry-runs run in subprocesses,
    all seven at once, while this process runs the real step.
    ``train_full`` is what ``phase_train_full`` returned."""
    from repro_torch.bench import bridge_validation
    from repro_torch.bench import run as bench_run

    results = ROOT / "results"
    results.mkdir(exist_ok=True)
    cell_out = results / "dryrun.jsonl"
    perf_out = results / "perf_iters.jsonl"
    parts = [results / f"perf_iters.part{i}.jsonl"
             for i in range(len(DRYRUN_SECTION1))]
    others = [results / f"dryrun.cell{i}.jsonl"
              for i in range(len(DRYRUN_CELLS))]
    # records left by an earlier run must not pass for this one's
    for path in (cell_out, perf_out, *parts, *others):
        path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    dev = torch.device(device).type
    cell = _dryrun_proc(dev, DRYRUN_CELL, cell_out)
    full = _dryrun_proc(dev, None, code=_train_full_code(dev))
    section1 = [_dryrun_proc(dev, ["--arch", "falcon-mamba-7b", "--shape",
                                   "long_500k", *args], part)
                for args, part in zip(DRYRUN_SECTION1, parts)]
    cells = [_dryrun_proc(dev, args, out)
             for args, out in zip(DRYRUN_CELLS, others)]
    real = _real_train_step(torch, device)

    # (1) the production cell
    _dryrun_wait(cell, "gemma-2b x train_4k")
    rec = _last_record(cell_out)
    check(rec["status"] == "ok", f"[dryrun] production cell: {rec}")
    mem, rf = rec["memory"], rec["roofline"]
    check(mem["peak_bytes"] < DRYRUN_PEAK_LIMIT,
          f"[dryrun] production cell's peak {mem['peak_bytes']} B a device "
          f"under {DRYRUN_PEAK_LIMIT:.0f}")
    log(f"[dryrun] gemma-2b x train_4k @ {rec['mesh']} ({rec['chips']} "
        f"ranks of a fake process group, fake tensors on the card's device "
        f"type): args {mem['argument_bytes'] / 1e9:.3f} GB, temp "
        f"{mem['temp_bytes'] / 1e9:.3f} GB, peak "
        f"{mem['peak_bytes'] / 1e9:.3f} GB a device; compute "
        f"{rf['compute_s'] * 1e3:.2f} ms, memory {rf['memory_s'] * 1e3:.2f}"
        f" ms, collective {rf['collective_s'] * 1e3:.2f} ms, dominant "
        f"{rf['dominant']}, useful {rec['useful_compute_fraction']:.3f}; "
        f"collective bytes {rec['per_device']['collectives']}; proof "
        f"{rec['compile_s']} s, cost {rec['cost_compile_s']} s; "
        f"{rec['memory_analysis_str']}")

    # (2) the [train full] configuration against its real step
    pred = json.loads(_dryrun_wait(full, "[train full] configuration")
                      .strip().splitlines()[-1])
    check(pred["status"] == "ok", f"[dryrun] train_full: {pred}")
    pmem, prf = pred["memory"], pred["roofline"]
    check(pmem["argument_bytes"] == real["arg_bytes"],
          f"[dryrun] argument bytes {pmem['argument_bytes']} == the real "
          f"state's and batch's {real['arg_bytes']}")
    check(int(pred["per_device"]["flops"]) == real["flops"],
          f"[dryrun] FLOPs on fake tensors {pred['per_device']['flops']} == "
          f"FlopCounterMode over the real step {real['flops']}")
    ratio = pmem["peak_bytes"] / real["peak"]
    check(DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1],
          f"[dryrun] predicted peak {pmem['peak_bytes']} over the measured "
          f"{real['peak']}: {ratio:.4f} outside {DRYRUN_PEAK_BAND}")
    step_s = real["ms"] / 1e3
    hbm_gb = pred["per_device"]["hbm_bytes"] / 1e9
    log(f"[dryrun] {TRAIN_ARCH} bf16 remat AdamW {TRAIN_BATCH}x{TRAIN_SEQ} "
        f"on a 1x1 mesh: argument bytes {pmem['argument_bytes']} == the "
        f"real state + batch ({real['arg_bytes'] / 1e9:.3f} GB); FLOPs "
        f"{real['flops']:.6e} on fake tensors == FlopCounterMode over the "
        f"real step; peak predicted {pmem['peak_bytes'] / 1e9:.3f} GB, "
        f"measured {real['peak'] / 1e9:.3f} GB (ratio {ratio:.4f}, band "
        f"{DRYRUN_PEAK_BAND}); {pred['memory_analysis_str']}; the real step "
        f"{real['ms']:.1f} ms (CUDA events; [train full]'s mean "
        + (f"{train_full['step_ms']:.1f} ms" if train_full else "not run")
        + f") against bound_s {prf['bound_s'] * 1e3:.2f} ms ({prf['dominant']}"
        f": compute {prf['compute_s'] * 1e3:.2f} ms, memory "
        f"{prf['memory_s'] * 1e3:.2f} ms of {hbm_gb:.1f} GB unfused "
        f"traffic): bound / step "
        f"{prf['bound_s'] / step_s:.4f}, compute / step "
        f"{prf['compute_s'] / step_s:.4f}")

    # (3) bridge_validation §1's pair, read by the port's bridge_validation
    for proc, args in zip(section1, DRYRUN_SECTION1):
        _dryrun_wait(proc, f"falcon-mamba-7b x long_500k {args}")
    perf_out.write_text("".join(p.read_text() for p in parts))
    for p in parts:
        p.unlink()
    with contextlib.chdir(ROOT):
        bv = bridge_validation.run(device="cpu", print_fn=lambda *_: None)
    check(bv["records_available"] and "long_decode_speedup" in bv,
          f"[dryrun] bridge_validation read §1: {bv}")
    for args, rec1 in zip(DRYRUN_SECTION1,
                          map(json.loads, perf_out.read_text().splitlines())):
        r1 = rec1["roofline"]
        log(f"[dryrun] falcon-mamba-7b x long_500k @ {rec1['mesh']} "
            f"({rec1['tag']}): args {rec1['memory']['argument_bytes'] / 1e9:.3f}"
            f" GB, temp {rec1['memory']['temp_bytes'] / 1e9:.3f} GB; memory "
            f"{r1['memory_s'] * 1e3:.3f} ms, collective "
            f"{r1['collective_s'] * 1e3:.3f} ms, dominant {r1['dominant']}")
    log(f"[dryrun] bridge_validation §1: records_available "
        f"{bv['records_available']}, long_decode_speedup "
        f"{bv['long_decode_speedup']:.3f}, long_decode_remesh_agrees "
        f"{bv['long_decode_remesh_agrees']}")
    check(bv["long_decode_remesh_agrees"],
          f"[dryrun] §1: the 1x256 mesh's memory term under a quarter of "
          f"16x16's (long_decode_speedup {bv['long_decode_speedup']:.3f})")

    # (4) the BENCH writer's roofline pass over part 1's records
    saved = os.environ.get("REPRO_DRYRUN_JSONL")
    os.environ["REPRO_DRYRUN_JSONL"] = str(cell_out)
    log_path = results / "roofline_run.log"
    try:
        with open(log_path, "w") as f, contextlib.redirect_stdout(f), \
                contextlib.chdir(ROOT):
            rc = bench_run.main(["roofline", "--json",
                                 str(results / "BENCH_roofline.json")],
                                device=device)
    finally:
        if saved is None:
            os.environ.pop("REPRO_DRYRUN_JSONL")
        else:
            os.environ["REPRO_DRYRUN_JSONL"] = saved
    check(rc == 0, f"[dryrun] the writer's roofline pass exited {rc}")
    doc = json.loads((results / "BENCH_roofline.json").read_text())
    derived = doc["engines"]["batched"]["roofline"]["derived"]
    check(derived["cells_ok"] >= 1 and derived["cells_error"] == 0,
          f"[dryrun] roofline {derived}")
    log(f"[dryrun] the BENCH writer's roofline pass: {derived}")

    # (5) the other archs' cells on the 16x16 fake mesh
    for proc, args, out in zip(cells, DRYRUN_CELLS, others):
        _dryrun_wait(proc, " ".join(args))
        rec = _last_record(out)
        check(rec["status"] == "ok", f"[dryrun] {args}: {rec}")
        mem, rf = rec["memory"], rec["roofline"]
        log(f"[dryrun] {rec['arch']} x {rec['shape']} @ {rec['mesh']}: args "
            f"{mem['argument_bytes'] / 1e9:.3f} GB, temp "
            f"{mem['temp_bytes'] / 1e9:.3f} GB, peak "
            f"{mem['peak_bytes'] / 1e9:.3f} GB a device; compute "
            f"{rf['compute_s'] * 1e3:.2f} ms, memory "
            f"{rf['memory_s'] * 1e3:.2f} ms, collective "
            f"{rf['collective_s'] * 1e3:.2f} ms, dominant {rf['dominant']}; "
            f"proof {rec['compile_s']} s")
    log(f"[dryrun] {time.perf_counter() - t0:.1f} s in all")


def _example(torch, name, argv, device):
    """One twin's ``main(argv, device)``: its result, what it printed and
    its seconds (the card's work waited for)."""
    import importlib
    import io

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = mod.main(list(argv), device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    return result, buf.getvalue(), time.perf_counter() - t0


def phase_examples(torch, device):
    """The twins of ``examples/`` (``repro_torch.examples``) as a user runs
    them, on the card: quickstart, futureproof_whatif and autoshard_tops
    print on the card exactly what the same twins print on this host's CPU
    (which ``tests/test_torch_examples.py`` holds to the reference's
    printout, line for line); serve_batched answers its 12 requests of 24
    tokens, every token a vocabulary id; train_end_to_end at ``--smoke``
    restarts once after its injected fault, reaches its last step and
    lowers the loss.  What each printed goes to
    ``results/examples_<name>.log``."""
    from repro_torch.configs import get_config
    from repro_torch.core import clear_flexion_reference_cache

    results = ROOT / "results"
    results.mkdir(exist_ok=True)

    def keep(name, text):
        (results / f"examples_{name}.log").write_text(text)

    for name in EXAMPLES_DSE:
        # the flexion's reference values are cached across calls: each run
        # computes its own
        clear_flexion_reference_cache()
        _, got, secs = _example(torch, name, [], device)
        clear_flexion_reference_cache()
        _, want, host = _example(torch, name, [], "cpu")
        keep(name, got)
        lines = [line for line in got.splitlines() if line.strip()]
        check(lines and got == want,
              f"[examples] {name} on the card prints what it prints on the "
              f"CPU:\n{got[-1500:]}\n---\n{want[-1500:]}")
        log(f"[examples] {name}: {len(lines)} lines, equal to the CPU's; "
            f"{secs:.1f} s (the CPU {host:.1f} s); last: {lines[-1]}")

    served, out, secs = _example(torch, "serve_batched", [], device)
    keep("serve_batched", out)
    vocab = get_config("gemma-2b", smoke=True).vocab
    check([r.uid for r in served] == list(range(12))
          and all(len(r.tokens) == 24 and r.error is None
                  and ((r.tokens >= 0) & (r.tokens < vocab)).all()
                  for r in served),
          f"[examples] serve_batched: 12 requests of 24 tokens:\n{out}")
    log(f"[examples] serve_batched: {out.splitlines()[0]}; {secs:.1f} s")

    res, out, secs = _example(torch, "train_end_to_end",
                              EXAMPLES_TRAIN_ARGV, device)
    keep("train_end_to_end", out)
    losses = [m["loss"] for m in res.metrics_history]
    check(res.restarts == 1 and res.final_step == EXAMPLES_TRAIN_STEPS
          and np.isfinite(losses).all() and losses[-1] < losses[0],
          f"[examples] train_end_to_end: one restart, step "
          f"{EXAMPLES_TRAIN_STEPS}, a falling loss:\n{out[-2000:]}")
    log(f"[examples] train_end_to_end {' '.join(EXAMPLES_TRAIN_ARGV)}: "
        f"{out.splitlines()[-1]}; {secs:.1f} s")


def phase_decode_trace(torch, cfg, params, dec_ms, device, steps=8):
    """Where a bf16 decode step's time goes: torch.profiler over ``steps``
    greedy steps at batch SERVE_BATCH after a prefill of SERVE_PROMPT
    tokens — kernels a step and the card's kernel time a step, and the
    card's idle share of [serve]'s unprofiled decode step ``dec_ms``.  It
    runs last: the profiler slows every later launch-bound call in the
    process."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import models
    toks = _serve_prompts(torch, cfg, np.random.default_rng(1), device)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    *_, traced_ms = _greedy(torch, models, cfg, params, toks, steps,
                            decode_ctx=prof)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in kernels) / 1e3 / steps
    launched = sum(e.count for e in kernels) / steps
    check(launched > 0 and busy > 0, "the profiler saw the card's kernels")
    log(f"[decode trace] torch.profiler, {steps} bf16 steps at batch "
        f"{SERVE_BATCH}: {launched:.0f} kernels a step, card busy "
        f"{busy:.2f} ms a step; against [serve]'s unprofiled decode step of "
        f"{dec_ms:.2f} ms the card is idle {100 * (1 - busy / dec_ms):.1f}%"
        f" (under the profiler a step takes {traced_ms:.2f} ms)")


# The model path's attention (name, B, Sq, Skv, H, KV, d, q_offset): the
# benchmark cells' shapes (stablelm-3b and olmoe-1b-7b training at 4 x
# 4096, the stablelm prefill of 3824 queries into a 3840-key cache),
# chatglm3's GQA 32/2 at 2048 and a chunk of 1536 queries at offset 512;
# kernel against plain on the first and the last batch row, each row of o,
# dq, dk and dv held to ATTN_TRAIN_TOL of its own largest value (as
# tests/test_torch_cuda.py: an output rounds to bf16 once, so two sound
# results differ by at most one bf16 ulp, 2 ** -7 of the element), lse to
# ATTN_LSE_TOL of its largest value
ATTN_TRAIN = [("stablelm train", 4, 4096, 4096, 32, 32, 80, 0),
              ("olmoe train", 4, 4096, 4096, 16, 16, 128, 0),
              ("stablelm prefill", 16, 3824, 3840, 32, 32, 80, 0),
              ("GQA 32/2", 1, 2048, 2048, 32, 2, 128, 0),
              ("offset 512", 2, 1536, 2048, 32, 32, 80, 512)]
ATTN_TRAIN_TOL = 1e-2
ATTN_LSE_TOL = 1e-5
# the model step that takes the kernel: stablelm-3b at its widths, this
# many of its layers, one sequence of this many tokens
MODEL_ATTN_LAYERS, MODEL_ATTN_SEQ = 2, 2048


def row_err(got, want) -> float:
    """The largest error in a row (the last dim: one query's or one key's
    d values) over that row's largest value; a row below a thousandth of
    the tensor's largest value is held to that thousandth (query 0's dq,
    where dS cancels to rounding)."""
    got, want = got.float(), want.float()
    top = want.abs().amax(dim=-1)
    floor = 1e-3 * top.max()
    return ((got - want).abs().amax(dim=-1) / top.clamp(min=floor)
            ).max().item()


def attention_train_flops(b, sq, h, d, off) -> float:
    """Forward FLOPs of causal attention, query i at off + i: both
    products over the keys each query sees (the backward needs 2.5x)."""
    pairs = sq * off + sq * (sq + 1) / 2
    return 2.0 * 2.0 * b * h * d * pairs


def phase_attention_train(torch, at) -> dict:
    """The model path's attention kernels at ATTN_TRAIN: forward and
    backward ms (CUDA events, 5 calls after 2 warm ones) beside the FLOP
    bound at the bf16 peak; the plain op (forward_plain + backward_plain)
    and the flash twin (forward + autograd backward) on batch row 0;
    SDPA's default backend (forward, forward + backward) on (B, H, S, d)
    views as the library yardstick where the offset is 0 (its is_causal
    lets query i see keys 0..i, this op's mask there; the port never
    calls it); o, lse, dq, dk and dv against the plain op on the first
    and the last batch row; a second backward bit-identical.  Returns the
    kernels line's row: the stablelm train shape's forward + backward."""
    from repro_torch.models.attention import _flash_attention_jnp
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rel = lambda a, b: ((a.float() - b.float()).abs().max()  # noqa: E731
                        / b.float().abs().max()).item()
    row, worst_abs, worst_row = None, 0.0, 0.0
    for name, b, sq, skv, h, kv, d, off in ATTN_TRAIN:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(s, generator=g, device="cuda").bfloat16()
                       for s in ((b, sq, h, d), (b, skv, kv, d),
                                 (b, skv, kv, d), (b, sq, h, d)))
        scale = d ** -0.5
        o, lse = at.launch_forward(q, k, v, off, scale)
        grads = at.launch_backward(q, k, v, o, lse, do, off, scale)
        again = at.launch_backward(q, k, v, o, lse, do, off, scale)
        check(all(torch.equal(x, y) for x, y in zip(grads, again)),
              f"attention_train backward deterministic at {name}")
        errs, lse_err, rows = [0.0] * 4, 0.0, sorted({0, b - 1})
        for i in rows:
            r = slice(i, i + 1)
            o0, lse0 = at.forward_plain(q[r], k[r], v[r], off, scale)
            want = at.backward_plain(q[r], k[r], v[r], o[r], lse[r], do[r],
                                     off, scale)
            pairs = [(o[r], o0)] + [(x[r], w) for x, w in zip(grads, want)]
            errs = [max(e, row_err(x, w)) for e, (x, w) in zip(errs, pairs)]
            lse_err = max(lse_err, rel(lse[r], lse0))
            worst_abs = max([worst_abs] + [max_err(x, w) for x, w in pairs])
            del o0, lse0, want, pairs
        worst_row = max([worst_row] + errs)
        check(max(errs) < ATTN_TRAIN_TOL,
              f"attention_train == plain row by row at {name}: o, dq, dk, "
              f"dv {errs}")
        check(lse_err < ATTN_LSE_TOL,
              f"attention_train lse == plain at {name}: {lse_err}")
        fwd = bench_ms(lambda: at.launch_forward(q, k, v, off, scale), 5)
        bwd = bench_ms(lambda: at.launch_backward(q, k, v, o, lse, do, off,
                                                  scale), 5)
        flops = attention_train_flops(b, sq, h, d, off)
        bound_f = flops / PEAK_OPS["bfloat16"] * 1e3
        bound_b = 2.5 * bound_f

        def plain():
            o1, l1 = at.forward_plain(q[:1], k[:1], v[:1], off, scale)
            at.backward_plain(q[:1], k[:1], v[:1], o1, l1, do[:1], off, scale)

        def twin():
            ts = [t[:1].detach().requires_grad_(True) for t in (q, k, v)]
            pos = off + torch.arange(sq, device="cuda")
            _flash_attention_jnp(*ts, True, pos, None).backward(do[:1])

        plain_ms, twin_ms = bench_ms(plain, 1, 1), bench_ms(twin, 1, 1)
        lib = f"n/a (offset {off}: is_causal aligns query 0 with key 0)"
        lib_fb = None
        if off == 0:
            views = [t.transpose(1, 2) for t in (q, k, v)]
            kw = dict(is_causal=True, enable_gqa=h != kv)
            lib_err = row_err(sdpa(*views, **kw).transpose(1, 2), o)
            lib_f = bench_ms(lambda: sdpa(*views, **kw), 5)
            ts = [t.detach().requires_grad_(True) for t in views]
            lib_fb = bench_ms(lambda: sdpa(*ts, **kw).backward(
                do.transpose(1, 2)), 5)
            lib = (f"{lib_f:.3f} fwd, {lib_fb:.3f} fwd+bwd (its o against "
                   f"the kernel's, row by row: {lib_err:.2e})")
            del views, ts
        log(f"[attention train] {name} (B={b}, Sq={sq}, Skv={skv}, H={h}, "
            f"KV={kv}, d={d}, offset={off}): forward {fwd:.3f} ms "
            f"({flops / fwd / 1e9:.1f} TFLOP/s, bound {bound_f:.3f} ms, "
            f"{100 * bound_f / fwd:.1f}%), backward {bwd:.3f} ms "
            f"({2.5 * flops / bwd / 1e9:.1f} TFLOP/s, bound {bound_b:.3f} ms,"
            f" {100 * bound_b / bwd:.1f}%); batch row 0: plain op "
            f"{plain_ms:.1f} ms, flash twin {twin_ms:.1f} ms fwd+bwd; "
            f"library ms (SDPA default) {lib}; batch rows {rows}, "
            f"worst row's error over its largest value, o, dq, dk, dv "
            f"{', '.join(f'{e:.2e}' for e in errs)} (limit "
            f"{ATTN_TRAIN_TOL}), lse {lse_err:.2e}; backward deterministic")
        if row is None:
            row = dict(ms=fwd + bwd, plain_ms=plain_ms,
                       bound_ms=bound_f + bound_b, bound_by="operations",
                       library_ms=lib_fb)
        del q, k, v, do, o, lse, grads, again
        torch.cuda.empty_cache()
    log(f"[attention train] worst over the shapes: row error {worst_row:.2e}"
        f", absolute error {worst_abs:.3g}; the kernels line's ms is the "
        f"stablelm train shape's forward + backward, its plain_ms the plain "
        f"op's on one batch row of four")
    return dict(row, max_abs_err=worst_abs)


def phase_model_attention(torch, device, at) -> None:
    """A training step of the model that takes the kernel: stablelm-3b at
    its published widths with MODEL_ATTN_LAYERS of its layers, bfloat16,
    remat as configured, one sequence of MODEL_ATTN_SEQ tokens.  Its loss
    and gradients with attn_impl 'auto' (the kernel past 1024 queries)
    against 'flash_jnp' (the twin), and the op's launches in the 'auto'
    step alone: one forward a layer (two under remat, the replay) and one
    backward a layer; the twin's step launches none."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.model import loss_fn
    from repro_torch.tree import leaves

    base = get_config("stablelm-3b").replace(n_layers=MODEL_ATTN_LAYERS)
    check(base.dtype == "bfloat16" and base.hd in at.WIDTHS, f"{base}")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(base, gen, device)
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    toks = torch.randint(1, base.vocab, (1, MODEL_ATTN_SEQ + 1),
                         generator=gen, device=device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for impl in ("auto", "flash_jnp"):
        fn = at.attention_train
        fwd, bwd = fn.launches, fn.backward_launches
        loss, _ = loss_fn(base.replace(attn_impl=impl), params, batch)
        grads = torch.autograd.grad(loss, flat)
        torch.cuda.synchronize()
        out[impl] = (loss.float().item(), grads,
                     fn.launches - fwd, fn.backward_launches - bwd)
    want_fwd = MODEL_ATTN_LAYERS * (2 if base.remat else 1)
    (loss_k, g_k, fwd_k, bwd_k), (loss_t, g_t, fwd_t, bwd_t) = \
        out["auto"], out["flash_jnp"]
    check((fwd_k, bwd_k) == (want_fwd, MODEL_ATTN_LAYERS),
          f"[model attention] 'auto' launched attention_train {fwd_k} "
          f"forwards, {bwd_k} backwards (want {want_fwd}, "
          f"{MODEL_ATTN_LAYERS})")
    check((fwd_t, bwd_t) == (0, 0), "[model attention] the twin launched "
          f"attention_train {fwd_t}, {bwd_t} times")
    diff = sum(float((a.float() - b.float()).square().sum())
               for a, b in zip(g_k, g_t)) ** 0.5
    norm = sum(float(b.float().square().sum()) for b in g_t) ** 0.5
    check(abs(loss_k - loss_t) < 1e-2 * abs(loss_t) and diff < 0.1 * norm,
          f"[model attention] kernel and twin steps differ: loss {loss_k} "
          f"against {loss_t}, gradients {diff / norm:.3g} of their norm")
    log(f"[model attention] stablelm-3b, {MODEL_ATTN_LAYERS} layers, bf16, "
        f"remat {base.remat}, 1 x {MODEL_ATTN_SEQ} tokens: 'auto' launched "
        f"attention_train {fwd_k} forwards and {bwd_k} backwards, the twin "
        f"none; loss {loss_k:.6f} against the twin's {loss_t:.6f}, "
        f"gradients differ by {diff / norm:.3g} of their norm")


def parse_blocks(text: str):
    return [tuple(int(x) for x in blk.split("x"))
            for blk in text.split(",") if blk]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--attention-only", action="store_true")
    parser.add_argument("--attention-blocks", type=parse_blocks, default=[])
    parser.add_argument("--dryrun-only", action="store_true")
    parser.add_argument("--attention-train-only", action="store_true")
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
        from repro_torch.kernels import attention_train as at
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
    kmods = {"tiled_matmul": tm, "flash_attention": fa, "mamba_scan": ms,
             "attention_train": at}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")

    if args.dryrun_only:
        with phase("dryrun"):
            phase_dryrun(torch, "cuda")
        log(smi)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] csrc/*.cu for sm_90a in {time.perf_counter() - t0:.1f} s")
    for name in KERNELS + ("attention_train",):
        ptxas = _build.build_log(name).splitlines()
        regs = sorted({line.split("Used ")[1].split(" registers")[0]
                       for line in ptxas if "registers" in line})
        spills = sorted({line.strip() for line in ptxas if "spill" in line})
        log(f"[build] {name} instantiations use {regs} registers; {spills}")
    if args.attention_train_only:
        with phase("attention train"):
            phase_attention_train(torch, at)
        with phase("model attention"):
            phase_model_attention(torch, "cuda", at)
        log(smi)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
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
    with phase("attention train"):
        timing_at = phase_attention_train(torch, at)

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
    log(f"[main path] search -> bridge launches: {path1}; "
        f"{attention_bodies(kmods)}")
    check_search(core, layers, specs, results, walls)
    worst["tiled_matmul"] = max(worst["tiled_matmul"], check_bridge(
        torch, kernels, tm, rows, runner))

    # ---- main path 2, autotune: counts zeroed before, read after ---------
    zero_launches(kmods)
    with phase("autotune"):
        derived = autotune.run(mode="fast", shapes=FULL_SHAPES, print_fn=log)
    path2 = read_launches(kmods)
    bodies2 = attention_bodies(kmods)
    # ----------------------------------------------------------------------
    log(f"[main path] autotune launches: {path2}; {bodies2}")
    for name in KERNELS:
        check(path2[name] > 0, f"autotune launched {name}")
    with phase("autotune checks"):
        timing = check_autotune(torch, kernels, kb, kmods, derived, worst)

    # ---- main path 3, bridge validation: counts zeroed before, read after
    zero_launches(kmods)
    with phase("bridge validation"):
        bv = bridge_validation.run(print_fn=log)
    path3 = read_launches(kmods)
    bodies3 = attention_bodies(kmods)
    # ----------------------------------------------------------------------
    log(f"[main path] bridge validation launches: {path3}; {bodies3}")
    for name in KERNELS:
        check(path3[name] > 0, f"bridge validation launched {name}")
    phase_bridge_validation(torch, kernels, kb, kmods, bv, worst)

    with phase("dse"):
        phase_dse(torch)
    with phase("pipeline"):
        phase_pipeline(torch, "cuda")
    with phase("service"):
        phase_service("cuda")
    # ---- main path 10, the linter and the service's lock orders: counts
    # zeroed before, read after -----------------------------------------------
    zero_launches(kmods)
    with phase("analysis"):
        phase_analysis(torch, "cuda")
    path10 = read_launches(kmods)
    # ----------------------------------------------------------------------
    log(f"[main path] analysis launches: {path10} (the linter parses the "
        f"tree and the service's GA engine runs no kernel)")

    # ---- main path 4, the BENCH writer: counts zeroed before, read after -
    zero_launches(kmods)
    with phase("bench"):
        phase_bench()
    path4 = read_launches(kmods)
    bodies4 = attention_bodies(kmods)
    # ----------------------------------------------------------------------
    log(f"[main path] bench launches: {path4}; {bodies4}")
    for name in KERNELS:
        check(path4[name] > 0, f"the BENCH writer launched {name}")

    with phase("model"):
        phase_model(torch, "cuda")
    # ---- main path 11, a model step past 1024 queries: counts zeroed
    # before, read after ------------------------------------------------------
    zero_launches(kmods)
    with phase("model attention"):
        phase_model_attention(torch, "cuda", at)
    path11 = read_launches(kmods)
    backward11 = at.attention_train.backward_launches
    # ----------------------------------------------------------------------
    log(f"[main path] model attention launches: {path11}, attention_train "
        f"backward {backward11}")
    check(path11["attention_train"] > 0 and backward11 > 0,
          "the model step launched attention_train")
    # ---- main path 6, training: counts zeroed before, read after ---------
    zero_launches(kmods)
    with phase("train"):
        phase_train(torch, "cuda")
    with phase("train full"):
        one_device = phase_train_full(torch, "cuda")
    path6 = read_launches(kmods)
    bodies6 = attention_bodies(kmods)
    # ----------------------------------------------------------------------
    log(f"[main path] train launches: {path6}; {bodies6} (the model layers "
        f"take a kernel, attention_train, only past 1024 queries at d in "
        f"{at.WIDTHS}: these sequences are shorter and gemma-2b's d is 256, "
        f"so no kernel is on this path)")
    # ---- main path 7, sharded training and serving: counts zeroed before,
    # read after -------------------------------------------------------------
    zero_launches(kmods)
    with phase("dist"):
        phase_dist(torch, "cuda", one_device)
    path7 = read_launches(kmods)
    bodies7 = attention_bodies(kmods)
    # ----------------------------------------------------------------------
    log(f"[main path] dist launches: {path7}; {bodies7} (short sequences "
        f"and gemma-2b's d of 256: the model layers run the reference's "
        f"twins, no kernel)")
    # ---- main path 8, the dry-run group: counts zeroed before, read after -
    zero_launches(kmods)
    with phase("dryrun"):
        phase_dryrun(torch, "cuda", one_device)
    path8 = read_launches(kmods)
    # ----------------------------------------------------------------------
    log(f"[main path] dryrun launches: {path8} (fake tensors: no kernel is "
        f"on this path)")
    # ---- main path 9, the examples' twins: counts zeroed before, read after
    zero_launches(kmods)
    with phase("examples"):
        phase_examples(torch, "cuda")
    path9 = read_launches(kmods)
    # ----------------------------------------------------------------------
    log(f"[main path] examples launches: {path9} (the DSE runs no kernel "
        f"and the model layers run the reference's twins)")
    # ---- main path 5, token serving: counts zeroed before, read after ----
    zero_launches(kmods)
    with phase("serve"):
        served = phase_serve(torch, "cuda")
    path5 = read_launches(kmods)
    bodies5 = attention_bodies(kmods)
    # ----------------------------------------------------------------------
    log(f"[main path] serve launches: {path5}; {bodies5} (gemma-2b's d is "
        f"256, which attention_train does not instantiate: the model "
        f"layers run the reference's twins)")

    with phase("attention host floor"):
        host_floor(torch, fa)
    with phase("decode trace"):
        phase_decode_trace(torch, *served, "cuda")
        del served

    timing["attention_train"] = timing_at
    worst["attention_train"] = timing_at.pop("max_abs_err")
    launches = {name: path1[name] + path2[name] + path3[name] + path4[name]
                + path5[name] + path6[name] + path7[name] + path8[name]
                + path9[name] + path10[name] + path11[name]
                for name in kmods}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [dict(
        name=name, route="cuda",
        source=f"src/repro_torch/kernels/csrc/{name}.cu",
        replaces=REPLACES[name], launches=launches[name],
        max_abs_err=worst[name], **timing[name]) for name in kmods]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
