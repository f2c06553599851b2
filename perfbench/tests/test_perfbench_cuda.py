"""On the card, at each cell's own size: the control (the reference in
the program's place, products through float8) and each fault must fail
the cell's limits, and the program must pass them.  Skips without a
card.  Run on the card:

    python -m pytest -q -m cuda perfbench/tests/test_perfbench_cuda.py
"""
import json
import pathlib
import time

import pytest

from perfbench import bench, control
from perfbench.tests.conftest import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_control_and_faults_fail_the_limits(card, workload):
    cell = bench.Cell.load(pathlib.Path(REPO), workload)
    run = bench.Run(cell, 2**31 + 101, 10.0, False, card,
                    time.perf_counter())
    read = (control.train_readings if cell.mix["kind"] == "train"
            else control.serve_readings)
    readings = read(run, sound_only=False)
    readings.pop("detail", None)
    for name, numbers in readings.items():
        failed = [n for n, v in numbers.items()
                  if v > cell.limits.get(n, 0 if n == "failed" else v)]
        if name == "program":
            assert not failed, numbers
        else:
            assert failed, (name, numbers)
