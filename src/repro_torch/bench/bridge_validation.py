"""Beyond-paper validation: do the repo's *predictions* match *measured*
reality?  (The counterpart of ``benchmarks/bridge_validation.py``.)

Always-runnable kernel-bridge section (no external artifacts needed):
  0. genome -> kernel lowering: sampled genomes on tiny shapes lower to
     legal configs whose execution on the card matches the kernels/ref
     oracle, and the bridge's legality mirror agrees exactly with
     ``mapper.raw_tile_feasibility``.  On a CPU device the kernels are not
     run: the section checks lowering and legality only
     (``kernel_executed: false``).

Two checks against ``results/perf_iters.jsonl``, the records of the
port's dry-run (``repro_torch.launch.dryrun``; without that file the bench
reports ``records_available: false``, as the reference does).  Section 1's
two records:

  python -m repro_torch.launch.dryrun --arch falcon-mamba-7b \
      --shape long_500k --tag long_i0_falcon_base_refresh \
      --out results/perf_iters.jsonl
  python -m repro_torch.launch.dryrun --arch falcon-mamba-7b \
      --shape long_500k --mesh-shape 1x256 --tag long_i1_falcon_mesh1x256 \
      --out results/perf_iters.jsonl

(README gives section 2's, and ``--device cpu`` on the CPU):
  1. long_500k re-mesh: the bridge ranks a (1, N) mesh above the 16x16
     default for batch-1 decode; the measured memory terms must agree.
  2. kimi-k2 feasibility: the bridge says the 1T model only fits with
     FSDP-style sharding; the measured proof-compile memory must show the
     production (FSDP+SP) config within a small multiple of HBM while the
     no-SP variant is far outside.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..device import resolve_device
from .common import Table

PERF_PATH = "results/perf_iters.jsonl"


def _load(path):
    recs = {}
    if not os.path.exists(path):
        return recs
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            r = json.loads(line)
            recs[(r["arch"], r["shape"], r["mesh"], r.get("tag", ""))] = r
    return recs


def _kernel_bridge_checks(t, derived, device):
    """Genome -> kernel lowering checks on tiny shapes (always runnable)."""
    from ..core import (HWConfig, MeasuredRunner, attention_workload,
                        bridge_tile_feasible, config_legal, lower_mapping,
                        make_variant, mamba_workload, mapspace_for,
                        matmul_workload, parity_check, raw_tile_feasibility)
    from ..core.kernel_bridge import make_inputs

    hw = HWConfig()
    spec = make_variant("11001", hw=hw)     # T/O/R open: the kernel axes
    wls = {"matmul": matmul_workload(32, 32, 32),
           "attention": attention_workload(1, 32, 16),
           "mamba": mamba_workload(1, 16, 8, 4)}

    # bridge legality mirror vs the cost model's buffer feasibility (exact)
    rng = np.random.default_rng(11)
    tiles = rng.integers(1, 64, (256, 6)).astype(np.int32)
    buf = float(hw.buffer_elems)
    want = raw_tile_feasibility(torch.as_tensor(tiles, device=device),
                                buf).cpu().numpy()
    legality_ok = bool(np.array_equal(bridge_tile_feasible(tiles, buf),
                                      want))
    t.add("bridge legality", "mirror == raw_tile_feasibility",
          f"{len(tiles)} tile rows", legality_ok)
    derived["kernel_legality_consistent"] = legality_ok

    parity_ok = True
    checked = 0
    lowered = []
    can_execute = MeasuredRunner(device=device).available()
    for kind, wl in wls.items():
        space = mapspace_for(wl.layer, spec)
        genomes = space.clip(space.sample(np.random.default_rng(5), 4))
        configs = {lower_mapping(wl, space.decode(g)) for g in genomes}
        legal = all(config_legal(wl, c) for c in configs)
        lowered += [(wl, c) for c in sorted(configs, key=repr)]
        parity_ok &= legal
        if can_execute:
            inputs = make_inputs(wl, device=device)
            for cfg in configs:
                parity_ok &= parity_check(wl, cfg, inputs)[0]
            checked += len(configs)
        t.add(f"{kind} lowering", "legal + golden parity",
              f"{len(configs)} configs"
              + ("" if can_execute else " (lowering only)"), legal)
    derived["kernel_parity_ok"] = bool(parity_ok)
    derived["kernel_configs_checked"] = int(checked)
    derived["kernel_executed"] = bool(can_execute)
    # every (workload, lowered config), for a caller's further checks
    derived["_lowered"] = lowered


def run(device=None, print_fn=print) -> dict:
    """``device`` is where the legality mirror's tensor lives and the
    lowered configs run (``None``: the card)."""
    device = resolve_device(device)
    perf = _load(PERF_PATH)
    derived = {"records_available": bool(perf)}

    kt = Table("genome->kernel bridge",
               ["check", "prediction", "measured", "agrees"])
    _kernel_bridge_checks(kt, derived, device)
    kt.show(print_fn)

    if not perf:
        print_fn("[bridge_validation] no results/perf_iters.jsonl — write "
                 "the records with python -m repro_torch.launch.dryrun "
                 "(see this module's docstring)")
        return derived

    t = Table("TOPS-bridge predictions vs measured dry-run",
              ["check", "prediction", "measured", "agrees"])

    # 1) long-decode re-mesh
    base = perf.get(("falcon-mamba-7b", "long_500k", "16x16",
                     "long_i0_falcon_base_refresh"))
    remesh = perf.get(("falcon-mamba-7b", "long_500k", "1x256",
                       "long_i1_falcon_mesh1x256"))
    if base and remesh and base["status"] == remesh["status"] == "ok":
        m0 = base["roofline"]["memory_s"]
        m1 = remesh["roofline"]["memory_s"]
        agrees = m1 < m0 / 4
        t.add("long_500k S-axis", "1xN mesh >=4x better than 16x16",
              f"{m0 / m1:.1f}x better", agrees)
        derived["long_decode_remesh_agrees"] = agrees
        derived["long_decode_speedup"] = m0 / m1

    # 2) kimi SP necessity
    sp_on = perf.get(("kimi-k2-1t-a32b", "train_4k", "16x16",
                      "kimi_k2_cap1"))
    sp_off = perf.get(("kimi-k2-1t-a32b", "train_4k", "16x16",
                       "kimi_k1_nosp"))
    if sp_on and sp_off and sp_on["status"] == sp_off["status"] == "ok":
        g_on = sp_on["memory"]["temp_bytes"] / 1e9
        g_off = sp_off["memory"]["temp_bytes"] / 1e9
        agrees = g_on < 100 < g_off
        t.add("kimi-k2 P-axis", "1T fits only with SP sharding",
              f"SP-on {g_on:.0f}GB vs SP-off {g_off:.0f}GB", agrees)
        derived["kimi_sp_required_agrees"] = agrees

    t.show(print_fn)
    return derived
