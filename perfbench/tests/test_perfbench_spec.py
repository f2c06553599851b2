"""BENCHMARK.json against the rules its harness keeps: names, units,
which cell reports which metric, and every file a cell is found by
(its configuration's model family among them)."""
import json
import pathlib
import re

import pytest

from perfbench import bench

REPO = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
PB = REPO / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
CELLS = [w["name"] for w in SPEC["workloads"]]
# a width: a hidden, intermediate, latent, state or projection size, a
# head size, an expansion factor, the experts a token uses
WIDTH = re.compile(r"(_dim|_rank|_size)$|intermediate|latent|state|proj|"
                   r"head_dim|expan|per_tok")


def reports(metric, cell):
    return cell in metric.get("workloads", CELLS)


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"][:2] == ["python3", "perfbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]]
                         + CELLS + [m["name"] for m in METRICS])
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric["workloads"]) <= set(CELLS) \
        if "workloads" in metric else True
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert (PB / "metrics" / f"{metric['name']}.py").is_file()
        if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_one_end_to_end_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in metric.get("workloads", CELLS):
        assert reports(e2e[metric["moves"]], cell), (metric["name"], cell)


def test_layers_named_alike():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all(1 <= len(layer) <= 200 and "\n" not in layer
               for layer in layers)


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_each_cell_has_its_files_and_metrics(cell):
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    e2e = [m["name"] for m in SPEC["end_to_end"] if reports(m, cell["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(m, cell["name"]) for m in SPEC["per_layer"])
    for path in (f"configs/{cell['config']}.json",
                 f"traffic/{cell['traffic']}.json",
                 f"limits/{cell['name']}.json"):
        assert (PB / path).is_file(), path
    mix = json.loads((PB / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (PB / "kinds" / f"{mix['kind']}.py").is_file()
    conf = json.loads((PB / "configs" / f"{cell['config']}.json").read_text())
    assert (PB / "families" / f"{bench.family_name(conf)}.py").is_file()


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entry_matches_its_file(entry):
    assert entry["file"].startswith("perfbench/configs/")
    conf = json.loads((REPO / entry["file"]).read_text())
    assert conf["name"] == entry["name"]
    assert conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key), key
        assert key in conf
        assert conf["published"][key] != conf[key]
    assert any(entry["name"] == w["config"] for w in SPEC["workloads"])
