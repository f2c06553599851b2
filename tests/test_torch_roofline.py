"""The port's roofline bench (``repro_torch.bench.roofline``) against
``benchmarks/roofline.py`` on the same dry-run records: derived keys and
printed tables equal; the latest record of a cell wins; with no records
it runs the port's dry-run (never the reference's) in a subprocess; and
the BENCH writer's ``roofline`` cell."""
import json

import pytest

import benchmarks.roofline as ref
from repro_torch.bench import roofline
from repro_torch.bench import run as writer


def _ok(arch, shape, mesh, compute, temp=2e9):
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
            "chips": 256, "compile_s": 3.2,
            "memory": {"argument_bytes": 1.5e9, "output_bytes": 1.5e9,
                       "temp_bytes": temp, "peak_bytes": 1.5e9 + temp},
            "roofline": {"compute_s": compute, "memory_s": 0.02,
                         "collective_s": 0.001, "dominant": "compute",
                         "bound_s": compute, "roofline_fraction": 1.0},
            "useful_compute_fraction": 0.71}


RECORDS = [
    _ok("gemma-2b", "train_4k", "16x16", 0.5),
    _ok("gemma-2b", "train_4k", "16x16", 0.25),          # the latest wins
    {"arch": "gemma-2b", "shape": "long_500k", "mesh": "16x16",
     "status": "skipped", "reason": "full attention"},
    {"arch": "olmoe-1b-7b", "shape": "decode_32k", "mesh": "16x16",
     "status": "error", "error": "RuntimeError: x"},
    {"arch": "whisper-base", "shape": "train_4k", "mesh": "16x16",
     "status": "ok", "chips": 256, "compile_s": 20.0,
     "memory": {"argument_bytes": 9e7, "temp_bytes": 2.6e11}},
    _ok("falcon-mamba-7b", "prefill_32k", "2x16x16", 0.1),
    {"arch": "zamba2-2.7b", "shape": "train_4k", "mesh": "2x16x16",
     "status": "error", "error": "x"},
    _ok("falcon-mamba-7b", "long_500k", "1x256", 0.001),
]


@pytest.fixture
def records(tmp_path, monkeypatch):
    path = tmp_path / "dryrun.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in RECORDS))
    monkeypatch.setenv("REPRO_DRYRUN_JSONL", str(path))
    monkeypatch.setattr(ref.load_records, "__defaults__", (str(path),))
    return path


def test_run_equals_the_reference(records):
    want_lines, got_lines = [], []
    want = ref.run(print_fn=want_lines.append)
    got = roofline.run(print_fn=got_lines.append)
    assert got == want
    assert got_lines == want_lines
    assert got == {"cells_ok": 1, "cells_skipped": 1, "cells_error": 1,
                   "multi_pod_ok": 1}


def test_latest_record_wins(records):
    recs = roofline.load_records()
    assert recs == ref.load_records()
    (cell,) = [r for r in recs if r["arch"] == "gemma-2b"
               and r["shape"] == "train_4k"]
    assert cell["roofline"]["compute_s"] == 0.25
    assert len(recs) == len(RECORDS) - 1


@pytest.mark.parametrize("device", [None, "cpu"])
def test_no_records_runs_the_ports_dry_run(tmp_path, monkeypatch, device):
    path = tmp_path / "none.jsonl"
    monkeypatch.setenv("REPRO_DRYRUN_JSONL", str(path))
    calls = []

    def fake_run(cmd, **kw):
        calls.append((cmd, kw))
        path.write_text(json.dumps(_ok("gemma-2b", "train_4k", "16x16",
                                       0.3)) + "\n")

    monkeypatch.setattr(roofline.subprocess, "run", fake_run)
    got = roofline.run(print_fn=lambda *_: None, device=device)
    assert got["cells_ok"] == 1
    (cmd, kw), = calls
    assert cmd[1:3] == ["-m", "repro_torch.launch.dryrun"]
    assert not any(a.startswith("repro.") for a in cmd)
    assert cmd[3:] == ["--arch", "gemma-2b", "--shape", "train_4k",
                       "--out", str(path)] + (
                           ["--device", "cpu"] if device else [])
    assert kw["env"]["PYTHONPATH"].split(":")[0].endswith("src")


def test_the_writers_roofline_cell(records, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = writer.main(["roofline", "--json", "b.json"], device="cpu")
    assert rc == 0
    doc = json.loads((tmp_path / "b.json").read_text())
    cell = doc["engines"]["batched"]["roofline"]
    assert cell["derived"] == {"cells_ok": 1, "cells_skipped": 1,
                               "cells_error": 1, "multi_pod_ok": 1}
    assert "roofline" in writer.BENCHES
    assert "roofline" not in writer.PARITY_BENCHES
