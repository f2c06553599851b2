"""The port's genome -> kernel bridge against the JAX package's: lowering
(with the TPU constants patched in, equal to the reference; with the Hopper
constants, legal within the shared-memory budget), the buffer-legality
mirror, predicted runtime, and the measured-objective tuner under one
frozen timer."""
import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import kernel_bridge as j_kb  # noqa: E402
from repro.core import mapper as j_mapper  # noqa: E402
from repro.core import spec as j_spec  # noqa: E402
from repro.core.mapspace import mapspace_for as j_space  # noqa: E402
from repro.core.result_cache import ResultCache as JCache  # noqa: E402
from repro.kernels.tiled_matmul import vmem_bytes  # noqa: E402

from repro_torch.core import convert  # noqa: E402
from repro_torch.core import kernel_bridge as t_kb  # noqa: E402
from repro_torch.core import mapper as t_mapper  # noqa: E402
from repro_torch.core.result_cache import ResultCache as TCache  # noqa: E402
from repro_torch.kernels.tiled_matmul import SMEM_LIMIT_BYTES  # noqa: E402

CPU = "cpu"
SPECS = {
    "T/O/R open": j_spec.make_variant("11001"),
    "FullFlex11111": j_spec.make_variant("11111"),
    "f32 T/O": j_spec.make_variant("1100", fixed_bits=32),
}
WORKLOADS = [(64, 64, 64), (3072, 512, 768), (512, 64, 512), (96, 40, 24)]
SPEC_F32 = SPECS["f32 T/O"]


def _t(spec):
    return convert.spec_from_dict(dataclasses.asdict(spec))


def _mappings(shape, spec, n=48, seed=0):
    """(JAX mapping, port mapping) pairs of sampled genomes."""
    wl = j_kb.matmul_workload(*shape)
    space = j_space(wl.layer, spec)
    g = space.clip(space.sample(np.random.default_rng(seed), n))
    out = []
    for row in g:
        jm = space.decode(row)
        out.append((jm, convert.mapping_from_dict(dataclasses.asdict(jm))))
    return out


def _cfg_dict(cfg):
    return dataclasses.asdict(cfg)


@pytest.fixture
def tpu_constants(monkeypatch):
    """The port's lowering constants set to the TPU's, read at call time:
    with them the port must lower exactly as the reference does."""
    monkeypatch.setattr(t_kb, "TILE_ALIGN", j_kb.MXU_ALIGN)
    monkeypatch.setattr(t_kb, "SMEM_BUDGET_BYTES", j_kb.VMEM_BUDGET_BYTES)
    monkeypatch.setattr(t_kb, "smem_bytes", vmem_bytes)


@pytest.mark.parametrize("shape", WORKLOADS)
@pytest.mark.parametrize("name", sorted(SPECS))
def test_lowering_with_tpu_constants_equals_reference(name, shape,
                                                      tpu_constants):
    jw, tw = j_kb.matmul_workload(*shape), t_kb.matmul_workload(*shape)
    for jm, tm in _mappings(shape, SPECS[name]):
        j_cfg = j_kb.lower_mapping(jw, jm)
        t_cfg = t_kb.lower_mapping(tw, tm)
        assert _cfg_dict(t_cfg) == _cfg_dict(j_cfg)
        assert t_kb.config_legal(tw, t_cfg) == j_kb.config_legal(jw, j_cfg)


@pytest.mark.parametrize("shape", WORKLOADS)
@pytest.mark.parametrize("name", sorted(SPECS))
def test_hopper_lowering_is_total_and_legal(name, shape):
    wl = t_kb.matmul_workload(*shape)
    for _, tm in _mappings(shape, SPECS[name], seed=1):
        cfg = t_kb.lower_mapping(wl, tm)
        assert t_kb.config_legal(wl, cfg)
        db = {8: 1, 16: 2, 32: 4}[cfg.bits]
        assert t_kb.smem_bytes(*cfg.block, db) <= t_kb.SMEM_BUDGET_BYTES
        assert t_kb.SMEM_BUDGET_BYTES == SMEM_LIMIT_BYTES == 232_448
        for dim, b in zip(shape, cfg.block):
            assert dim % b == 0
        assert cfg == t_kb.lower_mapping(wl, tm)


def test_snap_and_order_helpers_match_reference():
    for dim in (1, 7, 24, 64, 96, 768, 3072):
        for target in (1, 3, 8, 17, 64, 5000):
            for align in (1, 8, 16):
                assert t_kb._snap_block(dim, target, align) == \
                    j_kb._snap_block(dim, target, align)
    space = j_space(j_kb.matmul_workload(8, 8, 8).layer,
                    j_spec.make_variant("0100"))
    for perm in space.order_table:
        assert t_kb._matmul_order(tuple(perm)) == \
            j_kb._matmul_order(tuple(perm))


def test_bridge_tile_feasible_equals_raw_tile_feasibility():
    tiles = np.random.default_rng(3).integers(1, 160, (2000, 6))
    buf = float(j_spec.HWConfig().buffer_elems)
    mirror = t_kb.bridge_tile_feasible(tiles, buf)
    assert np.array_equal(mirror, j_kb.bridge_tile_feasible(tiles, buf))
    assert np.array_equal(
        mirror, t_mapper.raw_tile_feasibility(torch.as_tensor(tiles),
                                              buf).numpy())
    assert mirror.any() and not mirror.all()


@pytest.mark.parametrize("name", sorted(SPECS))
def test_predicted_runtime_matches_reference(name, tpu_constants):
    spec = SPECS[name]
    jw, tw = j_kb.matmul_workload(512, 64, 512), t_kb.matmul_workload(512,
                                                                       64,
                                                                       512)
    for jm, tm in _mappings((512, 64, 512), spec, n=10, seed=2):
        want = j_kb.predicted_runtime(jw, spec, jm)
        got = t_kb.predicted_runtime(tw, _t(spec), tm, device=CPU)
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _fake_timer(key):
    """Deterministic pseudo-measurement: a pure hash of the config key (the
    same key tuple in both packages)."""
    h = zlib.crc32(repr(key).encode()) % 10_000
    return 1e-4 + h * 1e-7


@pytest.mark.parametrize("shape", [(64, 64, 64), (96, 40, 24)])
def test_tune_kernel_frozen_timer_matches_reference(shape, tpu_constants):
    jw, tw = j_kb.matmul_workload(*shape), t_kb.matmul_workload(*shape)
    kw = dict(population=8, generations=3, engine="serial")
    j_res = j_kb.tune_kernel(
        jw, SPEC_F32, j_mapper.GAConfig(**kw),
        j_kb.MeasuredRunner(cache=JCache(), timer=_fake_timer,
                            force_available=True))
    t_res = t_kb.tune_kernel(
        tw, _t(SPEC_F32), t_mapper.GAConfig(**kw),
        t_kb.MeasuredRunner(cache=TCache(), timer=_fake_timer,
                            force_available=True, device=CPU))
    assert t_res.objective == j_res.objective == "measured"
    assert _cfg_dict(t_res.config) == _cfg_dict(j_res.config)
    assert np.array_equal(t_res.genome, j_res.genome)
    assert t_res.history == j_res.history
    assert t_res.best_cost == j_res.best_cost
    assert t_res.measured_configs == j_res.measured_configs > 0
    np.testing.assert_allclose(t_res.predicted, j_res.predicted, rtol=1e-6)


def test_tune_kernel_modeled_fallback_matches_reference():
    """No card: the port's runner has no kernels to time, so the tuner
    ranks by the modeled objective, as the reference does without Pallas."""
    shape = (64, 64, 64)
    kw = dict(population=8, generations=3, engine="serial")
    runner = t_kb.MeasuredRunner(device=CPU)
    assert not runner.available()
    t_res = t_kb.tune_kernel(t_kb.matmul_workload(*shape), _t(SPEC_F32),
                             t_mapper.GAConfig(**kw), runner)
    j_res = j_kb.tune_kernel(j_kb.matmul_workload(*shape), SPEC_F32,
                             j_mapper.GAConfig(**kw),
                             j_kb.MeasuredRunner(force_available=False))
    assert t_res.objective == j_res.objective == "modeled"
    assert t_res.measured_configs == 0
    assert _cfg_dict(t_res.config) == _cfg_dict(j_res.config)
    np.testing.assert_allclose(t_res.history, j_res.history, rtol=1e-6)


def test_rank_correlation_study_frozen_timer_matches_reference(
        tpu_constants):
    spec = SPECS["T/O/R open"]
    shape = (96, 40, 24)
    j_st = j_kb.rank_correlation_study(
        j_kb.matmul_workload(*shape), spec, n_samples=12,
        runner=j_kb.MeasuredRunner(cache=JCache(), timer=_fake_timer,
                                   force_available=True))
    t_st = t_kb.rank_correlation_study(
        t_kb.matmul_workload(*shape), _t(spec), n_samples=12,
        runner=t_kb.MeasuredRunner(cache=TCache(), timer=_fake_timer,
                                   force_available=True, device=CPU))
    assert [_cfg_dict(c) for c in t_st["configs"]] == \
        [_cfg_dict(c) for c in j_st["configs"]]
    np.testing.assert_allclose(t_st["predicted"], j_st["predicted"],
                               rtol=1e-6)
    assert t_st["measured"] == j_st["measured"]
    assert t_st["spearman"] == pytest.approx(j_st["spearman"], abs=1e-12)
    assert t_st["all_legal"]


def test_parity_and_inputs_match_reference(tpu_constants):
    shape = (96, 40, 24)
    jw, tw = j_kb.matmul_workload(*shape), t_kb.matmul_workload(*shape)
    j_in = j_kb.make_inputs(jw, seed=4)
    t_in = t_kb.make_inputs(tw, seed=4, device=CPU)
    for a, b in zip(j_in, t_in):
        assert np.array_equal(np.asarray(a), b.numpy())
    for jm, tm in _mappings(shape, SPECS["T/O/R open"], n=16, seed=5):
        j_cfg, t_cfg = j_kb.lower_mapping(jw, jm), t_kb.lower_mapping(tw, tm)
        ok, err = t_kb.parity_check(tw, t_cfg, t_in)
        assert ok and err == 0.0          # K=24: no int8 saturation
        want = np.asarray(j_kb.reference_output(jw, j_cfg, j_in),
                          np.float32)
        got = t_kb.reference_output(tw, t_cfg, t_in).float().numpy()
        assert np.array_equal(got, want)


def test_attention_and_mamba_kinds_wait_for_slice_2():
    mapping = _mappings((64, 64, 64), SPEC_F32, n=1)[0][1]
    for kind, shape in (("attention", (2, 64, 32)), ("mamba", (1, 32, 16,
                                                                8))):
        wl = t_kb.KernelWorkload(kind, shape)
        assert wl.layer.dims == j_kb.KernelWorkload(kind, shape).layer.dims
        with pytest.raises(NotImplementedError, match="slice 2"):
            t_kb.lower_mapping(wl, mapping)
        with pytest.raises(NotImplementedError, match="slice 2"):
            t_kb.make_inputs(wl, device=CPU)


def test_env_kill_switch_and_default_device(monkeypatch):
    monkeypatch.setenv("REPRO_NO_KERNELS", "1")
    assert not t_kb.MeasuredRunner(device=CPU,
                                   force_available=None).available()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_kb.MeasuredRunner()
