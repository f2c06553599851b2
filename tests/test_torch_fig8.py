"""fig8, buffer-size sensitivity (six buffer sizes, W-F(T) over every 4th
MnasNet layer), in the port against ``benchmarks/fig8_buffer.py``, fast
mode on the CPU: the port's derived values on the serial, batched and
campaign paths equal the reference's (floats at rel 1e-6, booleans and ints
equal), the three paths agree bit for bit, the pinned anchors
(``src/repro_torch/bench/anchors_fast.json``) equal the fresh reference
run, and the W-F(T) means equal the reference's flexion (float64) and move
by float32 rounding only on the card's float32 backend."""
import pytest

pytest.importorskip("torch")

from _torch_bench_parity import (PATHS, assert_matches, pinned,  # noqa: E402
                                 port_runs, reference_run)

BENCH = "fig8"


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


def test_float32_flexion_backend_keeps_the_derived_values(monkeypatch,
                                                          port):
    """The card's default flexion backend (float32 torch) on the CPU: the
    W-F(T) means move by float32 rounding only, and the derived values
    (``wf_increases`` among them) stay those of the float64 path."""
    from repro_torch.bench import fig8_buffer
    quiet = dict(mode="fast", path="batched", device="cpu",
                 print_fn=lambda *a, **k: None)
    monkeypatch.setenv("REPRO_FLEXION_BACKEND", "numpy")
    f64 = fig8_buffer.run(**quiet)
    monkeypatch.setenv("REPRO_FLEXION_BACKEND", "torch")
    f32 = fig8_buffer.run(**quiet)
    assert {k: v for k, v in f32.items() if not k.startswith("_")} == \
        port["batched"]
    assert f32["_wf_t"] == pytest.approx(f64["_wf_t"], rel=1e-6, abs=0.0)
    assert f64["_wf_t"][-1] > f64["_wf_t"][0]


def test_wf_t_means_equal_the_reference_flexion(monkeypatch):
    """The W-F(T) mean of each buffer size (the float64 host backend) equals
    the mean of the reference's ``benchmarks.common.flexion_reports`` on
    the same (buffer size, probe layer) pairs."""
    import numpy as np
    from benchmarks import common as j_common
    from repro.core import FULLFLEX as J_FULLFLEX
    from repro.core import HWConfig as J_HWConfig
    from repro.core import get_model as j_get_model
    from repro.core import make_variant as j_make_variant
    from repro_torch.bench import fig8_buffer
    monkeypatch.setenv("REPRO_FLEXION_BACKEND", "numpy")
    monkeypatch.delenv("REPRO_CAMPAIGN", raising=False)
    got = fig8_buffer.run(mode="fast", path="campaign", device="cpu",
                          print_fn=lambda *a, **k: None)["_wf_t"]
    probe = j_get_model("mnasnet")[::4]
    want = []
    for kb in fig8_buffer.SIZES_KB:
        spec = j_make_variant("1000", J_FULLFLEX,
                              hw=J_HWConfig(buffer_bytes=kb * 1024))
        reports = j_common.flexion_reports([(spec, l) for l in probe], 5_000)
        want.append(float(np.mean([r.per_axis_wf["T"] for r in reports])))
    assert got == pytest.approx(want, rel=1e-12, abs=0.0)
