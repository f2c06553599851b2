"""A configuration, a traffic mix, a per-layer metric and a model family
added as new files and entries alone, in a copy of the benchmark, are
found and run without an edit to any file that was there."""
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import pytest

from perfbench import bench
from perfbench.tests.conftest import (REPO, TINY_LIMITS, copy_benchmark,
                                      tiny_conf)

NEW_FAMILY = pathlib.Path(__file__).with_name("new_family")
# the program's falcon-mamba-7b block at its smoke size, in bfloat16
MAMBA = {
    "name": "tiny-mamba", "family": "mamba1-tiny",
    "source": "https://huggingface.co/tiiuae/falcon-mamba-7b",
    "num_hidden_layers": 2, "hidden_size": 64, "intermediate_size": 128,
    "state_size": 8, "conv_kernel": 4, "expand": 2, "time_step_rank": 8,
    "vocab_size": 256, "norm": "rmsnorm", "rms_norm_eps": 1e-6,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "vocab_pad_multiple": 256, "reduced": [],
    "port": {"arch": "falcon-mamba-7b", "overrides": {
        "n_layers": 2, "d_model": 64, "vocab": 256, "dt_rank": 8,
        "ssm_state": 8, "ssm_chunk": 8, "dtype": "bfloat16"}}}

METRIC = '''"""Tokens a step of the window, from the driver's observations."""


def read(obs):
    if obs["kind"] != "train" or not obs.get("steps"):
        return None
    return float(obs["steps"])
'''


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "perfbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_and_entries_are_found(tmp_path):
    root = copy_benchmark(tmp_path)
    before = digest(root)
    pb = root / "perfbench"
    conf = dict(tiny_conf("tiny-moe"), name="new-moe")
    (pb / "configs" / "new-moe.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "train-4x4096.json").read_text())
    mix.update(batch=2, seq_len=32, pool_batches=3)
    (pb / "traffic" / "new-mix.json").write_text(json.dumps(mix))
    (pb / "metrics" / "window_steps.new.py").write_text(METRIC)
    (pb / "limits" / "new-moe.new-mix.json").write_text(
        json.dumps(TINY_LIMITS["train"]))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "new-moe", "source": conf["source"],
                            "file": "perfbench/configs/new-moe.json",
                            "reduced": conf["reduced"], "why": "new"})
    spec["workloads"].append({"name": "new-moe.new-mix", "config": "new-moe",
                              "traffic": "new-mix", "chips": 1, "why": "new"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("new-moe.new-mix")
    spec["per_layer"].append({
        "name": "window_steps.new", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "Steps", "moves":
        "train_tokens_per_s", "workloads": ["new-moe.new-mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    after = digest(root)
    assert all(after[p] == h for p, h in before.items())
    traced = bench.run_cell(root, "new-moe.new-mix", 9, 0.3, True, "cpu",
                            time.perf_counter())
    assert traced["metrics"]["window_steps.new"]["value"] >= 1
    assert traced["correct"]
    plain = bench.run_cell(root, "new-moe.new-mix", 9, 0.3, False, "cpu",
                           time.perf_counter())
    assert set(plain["metrics"]) == {"train_tokens_per_s", "setup_s"}


def add_cell(root, conf, limits, family_files=False):
    """``conf`` and a cell of it under a small training mix, as new files
    and entries of the copy at ``root``; with ``family_files`` also the
    Mamba-1 family and its reference."""
    pb = root / "perfbench"
    if family_files:
        shutil.copy(NEW_FAMILY / "mamba1-tiny.py",
                    pb / "families" / "mamba1-tiny.py")
        shutil.copy(NEW_FAMILY / "mamba1_tiny.py",
                    pb / "reference" / "mamba1_tiny.py")
    (pb / "configs" / f"{conf['name']}.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "train-4x4096.json").read_text())
    mix.update(batch=2, seq_len=32, pool_batches=3)
    (pb / "traffic" / "new-mix.json").write_text(json.dumps(mix))
    cell = f"{conf['name']}.new-mix"
    (pb / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": conf["name"], "source": conf["source"],
                            "file": f"perfbench/configs/{conf['name']}.json",
                            "reduced": conf["reduced"], "why": "new"})
    spec["workloads"].append({"name": cell, "config": conf["name"],
                              "traffic": "new-mix", "chips": 1, "why": "new"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("train_tokens_per_s", "fwd_bwd_ms.train"):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return cell


# sound runs of this cell read grad_gap <= 0.0011 and change_gap <= 0.003
# on the CPU (seeds 1-12 and 2**31 + 9); half a batch reads grad_gap >=
# 0.04 and change_gap >= 0.14
MAMBA_LIMITS = {"grad_gap": 0.01, "change_gap": 0.02}
RUN_MAMBA = """
import json, pathlib, sys, time
sys.path[:0] = ['.', 'src']
import torch
torch.set_num_threads(2)
from perfbench import bench, faults, program
root, cell = pathlib.Path('.'), 'tiny-mamba.new-mix'
go = lambda trace, hooks=None: bench.run_cell(
    root, cell, 2**31 + 9, 0.3, trace, 'cpu', time.perf_counter(), hooks)
make = program.train_step(program.config(bench.Cell.load(root, cell).conf))[0]
print(json.dumps({'traced': go(True), 'plain': go(False),
                  'half': go(False, {'train_step': faults.half_batch(make)})}))
"""


def test_a_new_family_is_new_files_and_entries_only(tmp_path):
    """An attention-free family for the program's ``mamba1`` block, with
    its reference, configuration, limits and cell: the cell runs to
    ``correct`` from a checkout where it is new files alone, and a
    planted fault does not."""
    root = copy_benchmark(tmp_path)
    before = digest(root)
    add_cell(root, MAMBA, MAMBA_LIMITS, family_files=True)
    after = digest(root)
    assert all(after[p] == h for p, h in before.items())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # the checkout's own perfbench, as the benchmark's command runs it
    r = subprocess.run([sys.executable, "-c", RUN_MAMBA], cwd=root,
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["traced"]["correct"], out["traced"]["checks"]
    assert out["traced"]["metrics"]["fwd_bwd_ms.train"]["value"] > 0
    assert out["plain"]["correct"], out["plain"]["checks"]
    assert set(out["plain"]["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert not out["half"]["correct"], out["half"]["checks"]


def test_a_block_its_family_does_not_judge_is_refused(tmp_path):
    """The same configuration in the decoder family: refused before the
    program's train step is built, naming the block and the family."""
    root = copy_benchmark(tmp_path)
    cell = add_cell(root, dict(MAMBA, family="decoder"), MAMBA_LIMITS)

    def never(*args):
        raise AssertionError("the train step was built")
    with pytest.raises(ValueError, match="'mamba1'.*'decoder'"):
        bench.run_cell(root, cell, 3, 0.3, False, "cpu", time.perf_counter(),
                       {"train_step": never})
