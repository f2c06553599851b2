"""Runs of the harness with the timed path broken underneath (the look
for a card skipped, the CPU in its place): ``correct`` must come out
false for each fault the cell can have, and true without one."""
import time

import pytest

from perfbench import bench, faults


def run(root, cell, hooks=None, seed=2**31 + 11):
    return bench.run_cell(root, cell, seed, 0.5, False, "cpu",
                          time.perf_counter(), hooks)


@pytest.mark.parametrize("cell", ["tiny-dense.train", "tiny-moe.train",
                                  "tiny-dense.serve"])
def test_sound_run_is_correct(tiny_root, cell):
    r = run(tiny_root, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("cell", ["tiny-dense.train", "tiny-moe.train"])
@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_training_fault_is_not_correct(tiny_root, cell, fault):
    from perfbench import program
    cfg = program.config(bench.Cell.load(tiny_root, cell).conf)
    make_step = program.train_step(cfg)[0]
    r = run(tiny_root, cell, {"train_step": faults.TRAIN[fault](make_step)})
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_serving_fault_is_not_correct(tiny_root, fault):
    conf = bench.Cell.load(tiny_root, "tiny-dense.serve").conf
    r = run(tiny_root, "tiny-dense.serve",
            {"run_wave": faults.SERVE[fault](conf["vocab_size"])})
    assert not r["correct"], r["checks"]
