"""The port's autotune pass against ``benchmarks/autotune_bench.py``: both
under one frozen timer, on the reference's fast shapes, with the TPU's
lowering constants patched into the port, give the same derived keys and
the same tuned config per kernel kind.  Without a card and without a
frozen timer the pass has nothing to time and says so."""
import sys
import zlib
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro.core as j_core  # noqa: E402
from repro.core import kernel_bridge as j_kb  # noqa: E402
from repro.kernels.flash_attention import \
    vmem_bytes as attn_vmem  # noqa: E402
from repro.kernels.mamba_scan import vmem_bytes as scan_vmem  # noqa: E402
from repro.kernels.tiled_matmul import vmem_bytes  # noqa: E402

from repro_torch.bench import autotune  # noqa: E402
from repro_torch.core import kernel_bridge as t_kb  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:          # benchmarks/ lives at the repo root
    sys.path.insert(0, str(REPO))


def _fake_timer(key):
    """Deterministic pseudo-measurement: a pure hash of the config key (the
    same key tuple in both packages)."""
    return 1e-4 + (zlib.crc32(repr(key).encode()) % 10_000) * 1e-7


@pytest.fixture
def tpu_constants(monkeypatch):
    monkeypatch.setattr(t_kb, "TILE_ALIGN", j_kb.MXU_ALIGN)
    monkeypatch.setattr(t_kb, "SMEM_BUDGET_BYTES", j_kb.VMEM_BUDGET_BYTES)
    monkeypatch.setattr(t_kb, "matmul_smem_bytes", vmem_bytes)
    monkeypatch.setattr(t_kb, "attention_smem_bytes", attn_vmem)
    monkeypatch.setattr(t_kb, "mamba_smem_bytes", scan_vmem)


def _reference_pass(monkeypatch):
    """benchmarks/autotune_bench.py in fast mode with every runner frozen;
    returns (derived, tuned config per kind)."""
    from benchmarks import autotune_bench

    class FrozenRunner(j_kb.MeasuredRunner):
        def __init__(self, *args, **kw):
            kw.setdefault("timer", _fake_timer)
            kw.setdefault("force_available", True)
            super().__init__(*args, **kw)

    tuned = {}
    real_tune = j_core.tune_kernel

    def recording_tune(wl, *args, **kw):
        res = real_tune(wl, *args, **kw)
        tuned[wl.kind] = (res.config.block, res.config.order)
        return res

    monkeypatch.setattr(j_core, "MeasuredRunner", FrozenRunner)
    monkeypatch.setattr(j_core, "tune_kernel", recording_tune)
    monkeypatch.setenv("REPRO_BENCH_MODE", "fast")
    return autotune_bench.run(print_fn=lambda *a: None), tuned


def test_autotune_pass_matches_reference_under_frozen_timer(monkeypatch,
                                                            tpu_constants):
    want, want_tuned = _reference_pass(monkeypatch)
    got = autotune.run(mode="fast", device="cpu", timer=_fake_timer,
                       force_available=True, print_fn=lambda *a: None)
    assert got["kernels_available"] and want["pallas_available"]
    for key, value in want.items():
        if key != "pallas_available":
            assert got[key] == value, key
    assert got["configs_measured"] > 0 and got["parity_ok"]
    for kind in autotune.KINDS:
        run = got["_runs"][kind]
        tuned = run["tuned"].config
        assert (tuned.block, tuned.order) == want_tuned[kind]
        assert run["workload"].shape == autotune.SHAPES["fast"][kind]
        assert len(run["runner"].timed) == len(run["runner"].cache)


def test_autotune_pass_with_hopper_constants_is_legal_and_in_parity():
    got = autotune.run(mode="fast", device="cpu", timer=_fake_timer,
                       force_available=True, print_fn=lambda *a: None,
                       shapes={"matmul": (64, 64, 64),
                               "attention": (2, 64, 32),
                               "mamba": (1, 32, 16, 8)})
    assert got["parity_ok"] and got["tuned_legal_ok"]
    for kind in autotune.KINDS:
        run = got["_runs"][kind]
        for wl, cfg in run["runner"].timed:
            assert t_kb.config_legal(wl, cfg)


def test_autotune_without_a_card_measures_nothing():
    got = autotune.run(mode="fast", device="cpu", print_fn=lambda *a: None)
    assert got["kernels_available"] is False
    assert got["configs_measured"] == 0 and not got["parity_ok"]
