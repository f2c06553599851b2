"""Roofline table from the dry-run records (results/dryrun.jsonl), the
counterpart of ``benchmarks/roofline.py``.

Prints, per (arch x shape) on the single-pod mesh: the three roofline terms,
the dominant bottleneck, MODEL_FLOPS/counted FLOPs, and per-device memory.
The dry-run runs in a process of its own (a fake process group of the
mesh's size); this bench only *reads* its records, and runs one cell in a
subprocess when there are none.  The records' path is
``REPRO_DRYRUN_JSONL`` (default ``results/dryrun.jsonl``)."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Dict, List

from ..core.envvars import get_env
from .common import Table


def dryrun_path() -> str:
    return get_env("REPRO_DRYRUN_JSONL") or "results/dryrun.jsonl"


def load_records(path: str = None) -> List[Dict]:
    path = path or dryrun_path()
    if not os.path.exists(path):
        return []
    recs = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            r = json.loads(line)
            recs[(r["arch"], r["shape"], r["mesh"])] = r  # latest wins
    return list(recs.values())


def _src_path(env) -> str:
    """PYTHONPATH for the subprocess: this package's root first."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.pathsep.join([root] + ([env["PYTHONPATH"]]
                                     if env.get("PYTHONPATH") else []))


def ensure_some_records(print_fn=print, device=None) -> List[Dict]:
    recs = load_records()
    if recs:
        return recs
    # generate one representative cell so the bench is self-contained
    print_fn("[roofline] no dry-run records found; running one cell "
             "(gemma-2b x train_4k) in a subprocess...")
    path = dryrun_path()
    env = dict(os.environ)
    env["PYTHONPATH"] = _src_path(env)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "gemma-2b", "--shape", "train_4k", "--out", path]
    if device is not None:
        cmd += ["--device", str(device)]
    subprocess.run(cmd, env=env, check=False, timeout=1800)
    return load_records()


def run(print_fn=print, device=None):
    """``device`` is the dry-run subprocess's device type when it has to
    make records (``None``: the card)."""
    recs = ensure_some_records(print_fn, device)
    single = [r for r in recs if r["mesh"] == "16x16"]
    multi = [r for r in recs if r["mesh"] == "2x16x16"]

    t = Table("Roofline (single-pod 16x16, per-device terms)",
              ["arch", "shape", "status", "compute_ms", "memory_ms",
               "collective_ms", "dominant", "useful", "args_GB", "temp_GB"])
    n_ok = n_skip = n_err = 0
    for r in sorted(single, key=lambda r: (r["arch"], r["shape"])):
        if r["status"] == "skipped":
            n_skip += 1
            t.add(r["arch"], r["shape"], "SKIP(full-attn@500k)", "-", "-",
                  "-", "-", "-", "-", "-")
            continue
        if r["status"] != "ok" or "roofline" not in r:
            n_err += r["status"] != "ok"
            t.add(r["arch"], r["shape"], r["status"], "-", "-", "-", "-",
                  "-", "-", "-")
            continue
        n_ok += 1
        rf = r["roofline"]
        mem = r["memory"]
        t.add(r["arch"], r["shape"], "ok",
              round(rf["compute_s"] * 1e3, 2),
              round(rf["memory_s"] * 1e3, 2),
              round(rf["collective_s"] * 1e3, 2),
              rf["dominant"],
              round(r.get("useful_compute_fraction", 0), 3),
              round((mem["argument_bytes"] or 0) / 1e9, 2),
              round((mem["temp_bytes"] or 0) / 1e9, 2))
    t.show(print_fn)

    if multi:
        t2 = Table("Multi-pod proof (2x16x16): compile + memory",
                   ["arch", "shape", "status", "compile_s", "args_GB",
                    "temp_GB"])
        for r in sorted(multi, key=lambda r: (r["arch"], r["shape"])):
            if r["status"] == "ok":
                mem = r["memory"]
                t2.add(r["arch"], r["shape"], "ok", r.get("compile_s"),
                       round((mem["argument_bytes"] or 0) / 1e9, 2),
                       round((mem["temp_bytes"] or 0) / 1e9, 2))
            else:
                t2.add(r["arch"], r["shape"], r["status"], "-", "-", "-")
        t2.show(print_fn)

    return {"cells_ok": n_ok, "cells_skipped": n_skip, "cells_error": n_err,
            "multi_pod_ok": sum(r["status"] == "ok" for r in multi)}
