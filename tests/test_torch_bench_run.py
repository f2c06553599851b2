"""The port's BENCH writer (``python -m repro_torch.bench.run``) on the CPU:
its passes agree and it writes the reference writer's artifact (schema
``repro-bench-mapper/v7``: the top-level keys, cells and
``device_scaling`` block of the committed ``BENCH_mapper.json``); a pass
whose derived values differ, or a bench that raises, makes it exit 1; bad
arguments, or a set ``REPRO_DEVICES``, exit 2; without a card the
default device raises."""
import json
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.bench import run as writer  # noqa: E402
from repro_torch.bench.common import fast_anchors  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CELL_KEYS = {"us_per_call", "derived", "phases"}


@pytest.fixture
def committed():
    with open(REPO / "BENCH_mapper.json") as f:
        return json.load(f)


def test_writer_passes_agree_and_write_the_reference_layout(
        tmp_path, monkeypatch, committed):
    monkeypatch.chdir(tmp_path)
    rc = writer.main(["table3", "fig9", "--mode", "fast", "--engines",
                      "serial,batched", "--campaign", "--devices", "0,0",
                      "--json", "bench.json"], device="cpu")
    assert rc == 0
    doc = json.loads((tmp_path / "bench.json").read_text())
    assert set(doc) == set(committed)
    assert doc["schema"] == committed["schema"] == "repro-bench-mapper/v7"
    assert doc["bench_mode"] == "fast" and doc["warmup"] is True
    passes = ["serial", "batched", "campaign", "campaign-d0,0"]
    assert list(doc["engines"]) == passes
    anchors = fast_anchors()
    for label in passes:
        cells = doc["engines"][label]
        assert list(cells) == ["table3", "fig9"]
        for name, cell in cells.items():
            assert set(cell) <= CELL_KEYS and cell["us_per_call"] > 0
            assert cell["derived"] == anchors[name], (label, name)
        assert set(cells["fig9"]["phases"]) == set(
            committed["engines"]["batched"]["fig11"]["phases"]) - {
                "mse_model"}
    for key in ("speedup_serial_over_batched",
                "speedup_batched_over_campaign",
                "speedup_serial_over_campaign"):
        assert set(doc[key]) == {"table3", "fig9", "total"}
    scaling = doc["device_scaling"]
    assert set(scaling) == set(committed["device_scaling"])
    assert scaling["pass"] == "campaign-d0,0"
    assert scaling["devices_requested"] == "0,0"
    assert scaling["devices_available"] == 1      # a CPU call's pool
    results = json.loads((tmp_path / "results" / "bench_results.json")
                         .read_text())
    assert results["fig9"]["fullflex0100_speedup"] == \
        anchors["fig9"]["fullflex0100_speedup"]


def _stub(fn):
    return types.SimpleNamespace(run=fn)


def test_writer_exits_1_and_names_a_parity_mismatch(tmp_path, monkeypatch,
                                                     capsys):
    monkeypatch.chdir(tmp_path)

    def run(path="batched", print_fn=print):
        return {"speedup": 1.0 if path == "serial" else 1.0 + 2 ** -40}
    monkeypatch.setitem(writer.BENCHES, "fig9", (_stub(run), "speedup"))
    rc = writer.main(["fig9", "--mode", "fast", "--engines",
                      "serial,batched"], device="cpu")
    assert rc == 1
    err = capsys.readouterr().err
    assert "PARITY MISMATCH fig9" in err and "[batched]" in err


def test_writer_exits_1_when_a_bench_raises(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)

    def run(print_fn=print):
        raise RuntimeError("broken bench")
    monkeypatch.setitem(writer.BENCHES, "table3", (_stub(run), "x"))
    assert writer.main(["table3", "--mode", "fast"], device="cpu") == 1
    out = capsys.readouterr()
    assert ",ERROR:RuntimeError" in out.out and "broken bench" in out.err


@pytest.mark.parametrize("argv,mode", [
    (["--devices", "-1"], "fast"), (["--service", "0"], "fast"),
    (["--engines", "gpu"], "fast"), (["--json"], "fast"),
    (["--devices", ""], "fast"), (["--engines", ","], "fast"),
    ([], "huge")])
def test_writer_refuses_bad_arguments(argv, mode, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert writer.main(["table3", "--mode", mode] + argv,
                       device="cpu") == 2
    assert not (tmp_path / "results").exists()


def test_writer_refuses_a_set_device_pool_variable(tmp_path, monkeypatch,
                                                   capsys):
    """``REPRO_DEVICES`` would pool every pass behind the writer's back:
    the pool comes from ``--devices`` only."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("REPRO_DEVICES", "0,0")
    assert writer.main(["table3", "--mode", "fast"], device="cpu") == 2
    assert "--devices" in capsys.readouterr().err
    assert not (tmp_path / "results").exists()


def test_default_pass_is_one_batched_pass(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    seen = []

    def run(path="batched", devices=None, print_fn=print):
        seen.append((path, devices))
        return {"speedup": 1.0}
    monkeypatch.setitem(writer.BENCHES, "fig9", (_stub(run), "speedup"))
    monkeypatch.setattr(writer, "_warm_engine", lambda *a: None)
    assert writer.main(["fig9", "--json", "b.json"], device="cpu") == 0
    assert seen == [("batched", None)]
    doc = json.loads((tmp_path / "b.json").read_text())
    assert doc["bench_mode"] == "default" and list(doc["engines"]) == [
        "batched"]
    assert "device_scaling" not in doc


def test_autotune_cell_keeps_the_ports_key_and_drops_objects():
    derived = {"parity_ok": True, "kernels_available": True,
               "_rank_corr_matmul": 0.5, "_tuned_us_matmul": 12.0,
               "_runs": {"matmul": object()}}
    doc = writer._bench_json({"autotune": [("autotune", 10.0, True)]},
                             {"autotune": {"autotune": derived}}, "fast")
    cell = doc["engines"]["autotune"]["autotune"]
    assert cell["derived"] == {"parity_ok": True, "kernels_available": True}
    assert cell["measured"] == {"rank_corr_matmul": 0.5,
                                "tuned_us_matmul": 12.0}
    assert writer._file_results({"flexion": {"a": 1, "_reports": {}}}) == {
        "flexion": {"a": 1}}


def test_every_port_bench_is_registered():
    names = set(writer.BENCHES)
    assert names == {"table3", "fig7", "fig8", "fig9", "fig10", "fig11",
                     "fig12", "fig13", "flexion", "bridge", "service",
                     "autotune", "roofline"}
    assert writer.PARITY_BENCHES <= names


def test_writer_needs_a_card_by_default(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        writer.main(["table3"])
