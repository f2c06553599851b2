"""Shared by the port's bench parity tests (tests/test_torch_fig*.py,
tests/test_torch_table3_bridge.py): the reference bench of
``benchmarks/`` run once in fast mode on the CPU, the port's bench on every
MSE path, and the pinned anchors of ``src/repro_torch/bench/
anchors_fast.json``.

Writes the anchors from a fresh reference run (JAX on the CPU):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_torch_bench_parity.py
"""
import importlib
import json
import os
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:          # benchmarks/ lives at the repo root
    sys.path.insert(0, str(REPO))
if str(REPO / "src") not in sys.path:
    sys.path.insert(0, str(REPO / "src"))

PATHS = ("serial", "batched", "campaign")
ANCHOR_RTOL = 1e-6
# bench name -> (reference module, port module)
MODULES = {"fig8": "fig8_buffer", "fig9": "fig9_order",
           "fig10": "fig10_parallelism", "fig12": "fig12_arraysize",
           "table3": "table3_area"}
ANCHORS = REPO / "src" / "repro_torch" / "bench" / "anchors_fast.json"
QUIET = lambda *a, **k: None  # noqa: E731

from repro_torch.bench._compare import (  # noqa: E402
    derived_equal, public_derived as public)


def reference_run(bench: str) -> dict:
    """The reference bench's public derived values in fast mode, on its
    default (batched) engine, with no campaign or device pool set."""
    mod = importlib.import_module(f"benchmarks.{MODULES[bench]}")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_BENCH_MODE", "fast")
        for var in ("REPRO_ENGINE", "REPRO_CAMPAIGN", "REPRO_DEVICES"):
            mp.delenv(var, raising=False)
        return public(mod.run(print_fn=QUIET))


def port_runs(bench: str) -> dict:
    """path -> the port bench's public derived values in fast mode on the
    CPU."""
    mod = importlib.import_module(f"repro_torch.bench.{MODULES[bench]}")
    return {path: public(mod.run(mode="fast", path=path, device="cpu",
                                 print_fn=QUIET))
            for path in PATHS}


def assert_matches(got: dict, want: dict, rtol: float = ANCHOR_RTOL):
    """Same keys and value types (a float stays a float, a boolean a
    boolean); floats at ``rtol``, the rest equal."""
    assert {k: type(v) for k, v in got.items()} == \
        {k: type(v) for k, v in want.items()}
    assert derived_equal(got, want, rtol), (got, want)


def pinned(bench: str) -> dict:
    with open(ANCHORS) as f:
        return json.load(f)["derived"][bench]


def write_anchors() -> None:
    doc = {"bench_mode": "fast", "engine": "batched",
           "source": "benchmarks/*.run() with REPRO_BENCH_MODE=fast, JAX on "
                     "the CPU (tests/_torch_bench_parity.py)",
           "derived": {bench: reference_run(bench) for bench in MODULES}}
    with open(ANCHORS, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    write_anchors()
    print(f"wrote {ANCHORS.relative_to(REPO)}")
