"""table3 and bridge_validation in the port against the reference benches
on the CPU.

table3 is float64 host arithmetic, so the port equals
``benchmarks/table3_area.py`` at rel 1e-12, and its pinned anchors equal
the fresh reference run.  bridge_validation's kernel section: on a CPU
device the port lowers and checks legality only, and equals the
reference with its kernels switched off (``REPRO_NO_PALLAS``); with the
bridge's runner forced available, the port runs every lowered config
through the kernels' plain versions and equals the reference's own CPU run
(Pallas interpret mode): same configs checked, all in parity."""
import pytest

pytest.importorskip("torch")

from _torch_bench_parity import (QUIET, assert_matches, pinned,  # noqa: E402
                                 public, reference_run)

from repro_torch.bench import bridge_validation, table3_area  # noqa: E402
from repro_torch.core import kernel_bridge as t_kb  # noqa: E402


@pytest.fixture(scope="module")
def table3_reference():
    return reference_run("table3")


def test_table3_equals_reference(table3_reference):
    got = table3_area.run(print_fn=QUIET)
    assert_matches(got, table3_reference, rtol=1e-12)
    assert got["claim_all_under_2pct"] is True


def test_table3_pinned_anchors_equal_a_fresh_reference_run(
        table3_reference):
    assert pinned("table3") == table3_reference


def _reference_bridge(monkeypatch, kernels: bool) -> dict:
    from benchmarks import bridge_validation as j_bv
    if not kernels:
        monkeypatch.setenv("REPRO_NO_PALLAS", "1")
    return public(j_bv.run(print_fn=QUIET))


def test_bridge_validation_lowering_only_equals_reference(monkeypatch,
                                                          tmp_path):
    monkeypatch.chdir(tmp_path)          # no results/perf_iters.jsonl here
    want = _reference_bridge(monkeypatch, kernels=False)
    got = public(bridge_validation.run(device="cpu", print_fn=QUIET))
    assert got == want
    assert got["kernel_executed"] is False
    assert got["kernel_configs_checked"] == 0
    assert got["kernel_legality_consistent"] and got["kernel_parity_ok"]
    assert "long_decode_speedup" not in got
    assert got["records_available"] is False


def test_bridge_validation_executed_equals_reference(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    want = _reference_bridge(monkeypatch, kernels=True)
    monkeypatch.setattr(t_kb.MeasuredRunner, "available", lambda self: True)
    got = public(bridge_validation.run(device="cpu", print_fn=QUIET))
    assert got == want
    assert got["kernel_executed"] and got["kernel_parity_ok"]
    assert got["kernel_configs_checked"] > 0


def test_bridge_validation_returns_every_lowered_config():
    """The ``_lowered`` sidecar lists each (workload, config) the kernel
    section lowered, every one legal: what a card run holds against the
    kernels' plain versions."""
    got = bridge_validation.run(device="cpu", print_fn=QUIET)
    kinds = [wl.kind for wl, _ in got["_lowered"]]
    assert set(kinds) == {"matmul", "attention", "mamba"}
    assert all(t_kb.config_legal(wl, cfg) for wl, cfg in got["_lowered"])
    assert len(got["_lowered"]) == len(set(got["_lowered"]))


def test_bridge_validation_reads_the_dry_run_records(monkeypatch, tmp_path):
    """§1–2 read results/perf_iters.jsonl as the reference does."""
    import json
    monkeypatch.chdir(tmp_path)
    recs = [
        {"arch": "falcon-mamba-7b", "shape": "long_500k", "mesh": "16x16",
         "tag": "long_i0_falcon_base_refresh", "status": "ok",
         "roofline": {"memory_s": 8.0}},
        {"arch": "falcon-mamba-7b", "shape": "long_500k", "mesh": "1x256",
         "tag": "long_i1_falcon_mesh1x256", "status": "ok",
         "roofline": {"memory_s": 1.0}},
        {"arch": "kimi-k2-1t-a32b", "shape": "train_4k", "mesh": "16x16",
         "tag": "kimi_k2_cap1", "status": "ok",
         "memory": {"temp_bytes": 50e9}},
        {"arch": "kimi-k2-1t-a32b", "shape": "train_4k", "mesh": "16x16",
         "tag": "kimi_k1_nosp", "status": "ok",
         "memory": {"temp_bytes": 400e9}},
    ]
    (tmp_path / "results").mkdir()
    (tmp_path / "results" / "perf_iters.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in recs))
    want = _reference_bridge(monkeypatch, kernels=False)
    got = public(bridge_validation.run(device="cpu", print_fn=QUIET))
    assert got == want
    assert got["long_decode_speedup"] == 8.0
    assert got["long_decode_remesh_agrees"] and got["kimi_sp_required_agrees"]


def test_bridge_validation_reads_the_ports_own_dry_run(monkeypatch,
                                                       tmp_path):
    """§1's two records written by the port's dry-run on the CPU (cut to
    two layers: the bridge reads the cells' memory terms, and the records
    are keyed by arch, shape, mesh and tag), read by the port's
    bridge_validation and by the reference's, which agree."""
    from repro_torch.launch import dryrun

    monkeypatch.chdir(tmp_path)
    out = "results/perf_iters.jsonl"
    common = ["--arch", "falcon-mamba-7b", "--shape", "long_500k",
              "--override", "n_layers=2", "--device", "cpu", "--out", out]
    assert dryrun.main(common + ["--tag", "long_i0_falcon_base_refresh"]) == 0
    assert dryrun.main(common + ["--mesh-shape", "1x256",
                                 "--tag", "long_i1_falcon_mesh1x256"]) == 0
    want = _reference_bridge(monkeypatch, kernels=False)
    got = public(bridge_validation.run(device="cpu", print_fn=QUIET))
    assert got == want
    assert got["records_available"] is True
    assert got["long_decode_speedup"] > 0
    assert isinstance(got["long_decode_remesh_agrees"], bool)
