"""fig12, array-size sensitivity (classes 0001 and 1001 at 256 to 4096 PEs), in the port against ``benchmarks/fig12_arraysize.py``, fast mode on the
CPU: the port's derived values on the serial, batched and campaign paths
equal the reference's (floats at rel 1e-6, booleans and ints equal), the
three paths agree bit for bit, and the pinned anchors
(``src/repro_torch/bench/anchors_fast.json``) equal the fresh reference
run."""
import pytest

pytest.importorskip("torch")

from _torch_bench_parity import (PATHS, assert_matches, pinned,  # noqa: E402
                                 port_runs, reference_run)

BENCH = "fig12"


@pytest.fixture(scope="module")
def reference():
    return reference_run(BENCH)


@pytest.fixture(scope="module")
def port():
    return port_runs(BENCH)


@pytest.mark.parametrize("path", PATHS)
def test_port_path_equals_reference(path, port, reference):
    assert_matches(port[path], reference)


def test_paths_agree_bit_for_bit(port):
    assert port["serial"] == port["batched"] == port["campaign"]


def test_pinned_anchors_equal_a_fresh_reference_run(reference):
    assert pinned(BENCH) == reference
