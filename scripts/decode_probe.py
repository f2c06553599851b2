#!/usr/bin/env python3
"""Host cost of the port's gemma-2b bf16 decode step on one CUDA card,
before and after other work in the same process.

    python3 scripts/decode_probe.py --plan decode,dist,decode,diag
    python3 scripts/decode_probe.py --root OTHER_CHECKOUT --plan decode
    python3 scripts/decode_probe.py --plan smoke --skip dist

Loads the port and ``chip_smoke.py`` from the checkout ``--root`` (default:
this one), draws gemma-2b's params at its published widths in bfloat16
(seed 0) and runs the plan's items in order, printing one JSON line each:

* ``decode``: ``chip_smoke.py``'s [serve] decode measure (a prefill of
  4x32 tokens, then 16 greedy steps between CUDA events), three times
  after a warm-up; the host's microseconds per launch of a one-element
  ``add_`` (2000 launches, no sync inside); the garbage collector's runs
  a generation during the three;
* ``dist``: ``chip_smoke.py``'s ``[dist]`` phase whole; ``group`` /
  ``ungroup`` open / destroy its world-size-1 NCCL group, and
  ``smoke_archs`` / ``dist_train`` run its two halves alone (the smoke
  archs' 1x1-mesh steps, ``run_training`` at full width on the mesh);
* ``smoke``: the whole of ``chip_smoke.py``, its phases named in
  ``--skip`` left out; just before ``[serve]`` a ``diag`` line, and just
  after it the ``decode`` measure on ``[serve]``'s params with the
  garbage collector on, then off, and the ms of one full collection;
* ``diag``: threads of the process and the CPU seconds the busiest took
  over one second, Python's live and tracked object counts and the
  allocator's bytes;
* ``release``: ``gc.collect()`` and ``torch.cuda.empty_cache()``;
  ``clear_dtensor``: DTensor's sharding-propagation caches emptied;
  ``gc_freeze``: ``gc.freeze()``.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _threads():
    """(name, CPU seconds) of every thread of this process."""
    out = {}
    tick = os.sysconf("SC_CLK_TCK")
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/comm") as f:
                name = f.read().strip()
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            out[tid] = (name, (int(fields[11]) + int(fields[12])) / tick)
        except OSError:
            pass
    return out


def diag(torch):
    before = _threads()
    time.sleep(1.0)
    after = _threads()
    busy = sorted(((after[t][1] - before[t][1], after[t][0])
                   for t in after if t in before), reverse=True)
    return {"threads": len(after),
            "names": sorted({n for n, _ in after.values()}),
            "busiest": [[n, round(s, 3)] for s, n in busy[:4]],
            "gc_objects": len(gc.get_objects()),
            "gc_counts": gc.get_count(),
            "allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "reserved_gb": torch.cuda.memory_reserved() / 1e9}


def greedy_ms(torch, models, cfg, params, toks, steps):
    """Prefill ms and decode ms a step, as chip_smoke's ``_greedy``."""
    b, s = toks.shape
    start, mid, end = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
    with torch.inference_mode():
        cache = models.init_cache(cfg, b, s + steps, toks.device)
        start.record()
        logits, cache = models.prefill(cfg, params, {"tokens": toks}, cache)
        mid.record()
        for _ in range(steps):
            nxt = torch.argmax(logits, -1)
            logits, cache = models.decode_step(cfg, params, nxt[:, None],
                                               cache)
        end.record()
        end.synchronize()
    return start.elapsed_time(mid), mid.elapsed_time(end) / steps


def launch_us(torch, n=2000):
    a = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        a.add_(1)
    host = (time.perf_counter() - t0) * 1e6 / n
    torch.cuda.synchronize()
    return host


def decode_row(torch, models, cfg, params, toks):
    runs_before = [g["collections"] for g in gc.get_stats()]
    runs = [greedy_ms(torch, models, cfg, params, toks, 16)
            for _ in range(3)]
    gc_runs = [g["collections"] - b
               for g, b in zip(gc.get_stats(), runs_before)]
    return {"prefill_ms": [r[0] for r in runs],
            "decode_ms": [r[1] for r in runs],
            "launch_us": launch_us(torch), "gc_runs": gc_runs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--plan", default="decode")
    ap.add_argument("--skip", default="")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch import models
    from repro_torch.configs import get_config

    def emit(item, **row):
        print(json.dumps({"label": args.label, "item": item, **row}),
              flush=True)

    cfg = get_config("gemma-2b")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab, (4, 32)), device="cuda")
    params = None
    if args.plan.split(",") != ["smoke"]:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = models.init_params(cfg, gen, "cuda")
        greedy_ms(torch, models, cfg, params, toks, 16)       # warm-up
    smoke = tmp = None
    for item in args.plan.split(","):
        t0 = time.perf_counter()
        row = {}
        if item == "decode":
            row = decode_row(torch, models, cfg, params, toks)
        elif item == "diag":
            row = diag(torch)
        elif item == "release":
            gc.collect()
            torch.cuda.empty_cache()
        elif item == "clear_dtensor":
            from torch.distributed.tensor import DTensor
            prop = DTensor._op_dispatcher.sharding_propagator
            for name in dir(prop):
                fn = getattr(prop, name, None)
                if hasattr(fn, "cache_clear"):
                    fn.cache_clear()
                    row.setdefault("cleared", []).append(name)
        elif item == "gc_freeze":
            gc.freeze()
        else:
            if smoke is None:
                sys.path.insert(1, str(root))
                import chip_smoke as smoke
            if item == "dist":
                smoke.phase_dist(torch, "cuda")
            elif item == "group":
                tmp = tempfile.mkdtemp(prefix="decode_probe_")
                smoke._open_group(torch, "cuda", tmp)
            elif item == "ungroup":
                import torch.distributed as dist
                dist.destroy_process_group()
            elif item == "smoke_archs":
                from repro_torch.configs import ARCHS
                from repro_torch.launch.mesh import make_mesh
                mesh = make_mesh((1, 1), ("data", "model"), "cuda")
                for arch in sorted(ARCHS):
                    smoke._dist_smoke_arch(torch, "cuda", mesh, arch)
                del mesh
            elif item == "dist_train":
                from repro_torch.launch.train import run_training
                run_training(smoke.TRAIN_ARCH, smoke=False,
                             steps=smoke.DIST_STEPS,
                             batch=smoke.TRAIN_BATCH, seq=smoke.TRAIN_SEQ,
                             ckpt_every=smoke.DIST_STEPS + 1,
                             config_overrides={"fsdp": True},
                             print_fn=lambda *a: None, device="cuda")
            elif item == "smoke":
                serve = smoke.phase_serve

                def probed(torch_, device):
                    emit("before serve", **diag(torch_))
                    out = serve(torch_, device)
                    for on in (True, False):
                        if not on:
                            gc.disable()
                        emit(f"after serve, gc {'on' if on else 'off'}",
                             **decode_row(torch_, models, out[0], out[1],
                                          toks))
                        gc.enable()
                    t1 = time.perf_counter()
                    gc.collect()
                    emit("full collection",
                         gc_ms=(time.perf_counter() - t1) * 1e3)
                    return out

                smoke.phase_serve = probed
                for name in filter(None, args.skip.split(",")):
                    setattr(smoke, f"phase_{name}",
                            lambda *a, **k: None)
                row = {"rc": smoke.main([])}
            else:
                raise SystemExit(f"decode_probe: unknown item {item!r}")
        emit(item, s=time.perf_counter() - t0, **row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
