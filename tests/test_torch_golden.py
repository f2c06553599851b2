"""Golden anchors of the port: its fig7, fig11, fig13 and flexion benches in
fast mode on the CPU reproduce the derived values pinned in the committed
``BENCH_mapper.json`` (floats at rel 1e-6, as tests/test_golden_metrics.py
holds the JAX package) through every MSE path — serial, batched and the
cross-model campaign — and the three paths agree bit for bit."""
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.bench import (fig7_tile, fig11_shape,  # noqa: E402
                               fig13_futureproof, flexion_bench)

REPO = Path(__file__).resolve().parents[1]
GOLDEN_KEYS = {
    "fig7": ("fullflex1000_speedup", "partflex1000_speedup", "ordering_ok"),
    "fig11": ("fullflex_speedup", "partflexB_close_to_full"),
    "fig13": ("fullflex1111_geomean_future", "fullflex11111_geomean_future",
              "beats_inflex_everywhere", "fullflex1111_hf"),
    "flexion": ("campaign_matches_serial", "all_in_unit_interval",
                "partflex1000_hf_T", "fullflex1111_hf"),
}
PATHS = ("serial", "batched", "campaign")
ANCHOR_RTOL = 1e-6

_RESULTS = {}


@pytest.fixture(scope="module")
def golden():
    with open(REPO / "BENCH_mapper.json") as f:
        doc = json.load(f)
    assert doc["bench_mode"] == "fast"
    return {bench: {k: doc["engines"]["batched"][bench]["derived"][k]
                    for k in keys}
            for bench, keys in GOLDEN_KEYS.items()}


def _run(bench, path):
    quiet = dict(mode="fast", device="cpu", print_fn=lambda *a, **k: None)
    if bench == "flexion":      # no MSE: every path is the same pass
        return flexion_bench.run(**quiet)
    mod = {"fig7": fig7_tile, "fig11": fig11_shape,
           "fig13": fig13_futureproof}[bench]
    return mod.run(path=path, **quiet)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("bench", sorted(GOLDEN_KEYS))
def test_path_reproduces_committed_anchors(bench, path, golden):
    derived = _run(bench, path)
    got = {k: derived[k] for k in GOLDEN_KEYS[bench]}
    _RESULTS[(bench, path)] = got
    for key, want in golden[bench].items():
        if isinstance(want, float):
            assert got[key] == pytest.approx(want, rel=ANCHOR_RTOL), \
                (bench, key, path)
        else:
            assert got[key] == want, (bench, key, path)


@pytest.mark.parametrize("bench", sorted(GOLDEN_KEYS))
def test_paths_agree_bit_identically(bench):
    runs = {p: _RESULTS.get((bench, p)) for p in PATHS}
    if any(v is None for v in runs.values()):
        # run on its own (a worker that did not run the anchors): redo
        runs = {p: {k: _run(bench, p)[k] for k in GOLDEN_KEYS[bench]}
                for p in PATHS}
    for path in PATHS[1:]:
        assert runs[path] == runs[PATHS[0]], (bench, path)
