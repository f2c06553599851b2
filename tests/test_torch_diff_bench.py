"""The port's ``repro_torch.bench.diff_bench`` against the reference's
``scripts/diff_bench.py``: the same REQUIRED_KEYS, the same diff and
missing-key reports on BENCH_mapper.json, and ``--self-check`` over the
port's own ``bench/run.py``."""
import copy
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.bench import diff_bench  # noqa: E402
from repro_torch.bench.run import BENCH_SCHEMA, PARITY_BENCHES  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "_ref_diff_bench", REPO / "scripts" / "diff_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def anchor():
    return json.loads((REPO / "BENCH_mapper.json").read_text())


def _mutated(anchor):
    """A copy of the anchor with one metric changed and one required key
    dropped."""
    new = copy.deepcopy(anchor)
    derived = new["engines"]["batched"]["fig7"]["derived"]
    derived["fullflex1000_speedup"] += 1.0
    del new["engines"]["campaign"]["fig13"]["derived"]["fullflex1111_hf"]
    return new


def test_required_keys_equal_the_reference(ref):
    assert diff_bench.REQUIRED_KEYS == ref.REQUIRED_KEYS
    assert set(PARITY_BENCHES) <= set(diff_bench.REQUIRED_KEYS)


def test_self_check_passes_on_the_port(capsys):
    assert diff_bench.main(["--self-check"]) == 0
    assert f"all {len(PARITY_BENCHES)} parity benches" in \
        capsys.readouterr().out


def test_self_check_as_a_module_without_jax():
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "sys.argv = ['diff_bench', '--self-check']; "
            "runpy.run_module('repro_torch.bench.diff_bench', "
            "run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK: all")


def test_self_check_fails_on_a_planted_gap(tmp_path, capsys):
    run_py = tmp_path / "run.py"
    text = (REPO / "src" / "repro_torch" / "bench" / "run.py").read_text()
    planted = text.replace('PARITY_BENCHES = {"fig7",',
                           'PARITY_BENCHES = {"fig99", "fig7",', 1)
    assert planted != text
    run_py.write_text(planted)
    assert diff_bench.self_check(run_py) == 1
    assert "GAP: parity bench 'fig99'" in capsys.readouterr().err
    run_py.write_text("X = 1\n")
    assert diff_bench.self_check(run_py) == 2


@pytest.mark.parametrize("case", ["same", "mutated"])
def test_diff_and_missing_required_equal_the_reference(ref, anchor, case):
    new = anchor if case == "same" else _mutated(anchor)
    got = list(diff_bench.diff(new, anchor))
    assert got == list(ref.diff(new, anchor))
    missing = list(diff_bench.missing_required(new))
    assert missing == list(ref.missing_required(new))
    if case == "same":
        assert got == [] and missing == []
    else:
        assert [(e, b, k) for e, b, k, _, _ in got] == [
            ("batched", "fig7", "fullflex1000_speedup"),
            ("campaign", "fig13", "fullflex1111_hf")]
        assert missing == [("campaign", "fig13", "fullflex1111_hf")]


def test_missing_required_reads_the_port_schema(anchor):
    new = _mutated(anchor)
    new["schema"] = BENCH_SCHEMA
    assert list(diff_bench.missing_required(new)) == [
        ("campaign", "fig13", "fullflex1111_hf")]
    new["schema"] = "repro-bench-mapper/v4"
    assert list(diff_bench.missing_required(new)) == []


@pytest.mark.parametrize("case", ["same", "mutated", "rtol", "disjoint"])
def test_cli_exit_codes_equal_the_reference(ref, anchor, case, tmp_path,
                                            capsys):
    new = anchor
    argv = []
    if case == "mutated":
        new = _mutated(anchor)
    elif case == "rtol":
        new = copy.deepcopy(anchor)
        new["engines"]["batched"]["fig7"]["derived"][
            "fullflex1000_speedup"] *= 1 + 1e-9
        argv = ["--rtol", "1e-6"]
    elif case == "disjoint":
        new = {"schema": BENCH_SCHEMA, "engines": {"other": {}}}
    paths = [tmp_path / "new.json", tmp_path / "anchor.json"]
    paths[0].write_text(json.dumps(new))
    paths[1].write_text(json.dumps(anchor))
    argv += [str(p) for p in paths]
    got = diff_bench.main(argv)
    port_out = capsys.readouterr()
    assert got == ref.main(argv)
    assert port_out == capsys.readouterr()
    assert got == {"same": 0, "mutated": 1, "rtol": 0, "disjoint": 2}[case]
