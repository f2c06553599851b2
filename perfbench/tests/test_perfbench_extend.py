"""A configuration, a traffic mix and a per-layer metric added as new
files and entries alone, in a copy of the benchmark, are found and run
without an edit to any file that was there."""
import hashlib
import json
import time

from perfbench import bench
from perfbench.tests.conftest import TINY_LIMITS, copy_benchmark, tiny_conf

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
