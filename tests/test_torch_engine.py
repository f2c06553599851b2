"""The port's GA engines: serial <-> batched bit-identical within the port,
and ``search_model`` against the JAX package on BERT layers (best genomes
equal, objectives within rel 1e-6)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as j_engine  # noqa: E402
from repro.core import mapper as j_mapper  # noqa: E402
from repro.core import spec as j_spec  # noqa: E402
from repro.core import workloads as j_wl  # noqa: E402

from repro_torch.core import convert  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import mapper as t_mapper  # noqa: E402
from repro_torch.core.result_cache import ResultCache  # noqa: E402

CPU = "cpu"
BUDGET = dict(population=16, generations=8)
SPECS = {
    "InFlex": j_spec.inflex_baseline(),
    "FullFlex1111": j_spec.make_variant("1111"),
    "PartFlex1111": j_spec.make_variant("1111", j_spec.PARTFLEX),
    "FullFlex11111": j_spec.make_variant("11111"),
    "PartFlex10101": j_spec.make_variant("10101", j_spec.PARTFLEX),
}
BERT64 = j_wl.bert_base(seq=64)


def _t(spec):
    return convert.spec_from_dict(dataclasses.asdict(spec))


def _tl(layers):
    return [convert.layer_from_dict(dataclasses.asdict(l)) for l in layers]


def _identical(a, b):
    for f in ("runtime", "energy", "edp", "util", "dram_elems", "feasible",
              "history"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.mapping == b.mapping


@pytest.mark.parametrize("name", sorted(SPECS))
def test_serial_equals_batched_within_port(name):
    spec = _t(SPECS[name])
    layers = _tl(BERT64[:3] + j_wl.get_model("mnasnet")[27:29])
    cfg = t_mapper.GAConfig(seed=7, **BUDGET)
    batched = t_mapper.search_model(layers, spec, cfg, device=CPU)
    serial = t_mapper.search_model(
        layers, spec, dataclasses.replace(cfg, engine="serial"), device=CPU)
    assert batched.runtime == serial.runtime
    for a, b in zip(batched.per_layer, serial.per_layer):
        _identical(a, b)


@pytest.mark.parametrize("engine", ["batched", "serial"])
@pytest.mark.parametrize("name", ["InFlex", "FullFlex1111",
                                  "PartFlex10101"])
def test_search_model_matches_reference(name, engine):
    js = SPECS[name]
    layers = BERT64[:4]
    j_res = j_mapper.search_model(layers, js,
                                  j_mapper.GAConfig(engine=engine, **BUDGET))
    t_res = t_mapper.search_model(_tl(layers), _t(js),
                                  t_mapper.GAConfig(engine=engine, **BUDGET),
                                  device=CPU)
    for a, b in zip(j_res.per_layer, t_res.per_layer):
        assert dataclasses.asdict(b.mapping) == dataclasses.asdict(a.mapping)
        for f in ("runtime", "energy", "edp", "util", "dram_elems"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f),
                                       rtol=1e-6, err_msg=f)
        assert b.feasible == a.feasible
        np.testing.assert_allclose(b.history, a.history, rtol=1e-6)
    np.testing.assert_allclose(t_res.runtime, j_res.runtime, rtol=1e-6)


def test_row_planning_and_keys_match_reference():
    cfg_j = j_mapper.GAConfig(**BUDGET)
    cfg_t = t_mapper.GAConfig(**BUDGET)
    layers = j_wl.get_model("resnet50")
    assert t_mapper.plan_model_rows(_tl(layers)) == \
        j_mapper.plan_model_rows(layers)
    assert t_engine.ga_params_key(cfg_t) == j_engine.ga_params_key(cfg_j)
    js = SPECS["FullFlex1111"]
    j_key = j_engine.row_cache_key(j_engine.EngineRow(layers[0], js, 5),
                                   cfg_j)
    t_key = t_engine.row_cache_key(
        t_engine.EngineRow(_tl(layers[:1])[0], _t(js), 5), cfg_t)
    assert t_key[:2] + t_key[3:] == j_key[:2] + j_key[3:]
    assert (t_engine.ROW_BUCKET, t_engine.GEN_BUCKET, t_engine.TABLE_BUCKET) \
        == (j_engine.ROW_BUCKET, j_engine.GEN_BUCKET, j_engine.TABLE_BUCKET)


def test_prepare_chunk_equals_reference():
    js = SPECS["FullFlex11111"]
    rows_j = [j_engine.EngineRow(l, js, 1000 * i)
              for i, l in enumerate(BERT64)]
    rows_t = [t_engine.EngineRow(l, _t(js), 1000 * i)
              for i, l in enumerate(_tl(BERT64))]
    cfg = dict(population=12, generations=3)
    a = j_engine._prepare_chunk(rows_j, j_mapper.GAConfig(**cfg), js.hw)
    b = t_engine._prepare_chunk(rows_t, t_mapper.GAConfig(**cfg),
                                _t(js).hw)
    for f, x, y in zip(j_engine.ChunkInputs._fields, a, b):
        if f == "draws":
            for xx, yy in zip(x, y):
                assert xx.tobytes() == yy.tobytes()
        elif f == "gens":
            assert x == y
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_row_cache_answers_without_changing_results():
    spec = _t(SPECS["FullFlex1111"])
    cfg = t_mapper.GAConfig(**BUDGET)
    rows = [t_engine.EngineRow(l, spec, 1000 * i)
            for i, l in enumerate(_tl(BERT64[:3]))]
    fresh = t_engine.run_batched_ga(rows, cfg, device=CPU)
    cache = ResultCache()
    first = t_engine.run_batched_ga(rows + rows[:1], cfg, row_cache=cache,
                                    device=CPU)
    assert len(cache) == 3
    again = t_engine.run_batched_ga(rows, cfg, row_cache=cache, device=CPU)
    for a, b, c in zip(fresh, first, again):
        assert np.array_equal(a.best_genome, b.best_genome)
        assert a.best_obj == b.best_obj == c.best_obj
    assert first[3] is first[0]
    assert t_engine.run_batched_ga([], cfg, device=CPU) == []


@pytest.mark.parametrize("kw", [
    dict(population=1), dict(generations=0), dict(elite_frac=1.0),
    dict(mutation_rate=1.5), dict(crossover_rate=-0.1),
    dict(objective="latency"), dict(engine="fast"), dict(devices=0),
    dict(devices="-1"), dict(devices=()),
])
def test_gaconfig_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        j_mapper.GAConfig(**kw)
    with pytest.raises(ValueError):
        t_mapper.GAConfig(**kw)


def test_devices_and_pipeline_wait_for_slice_3():
    """Slice 3 brought the device pool and the in-flight queue: a pooled
    (a count clamps to the one CPU device) or pipelined engine run equals
    the plain run and the reference's."""
    assert t_mapper.GAConfig(devices="0,1").devices == \
        j_mapper.GAConfig(devices="0,1").devices
    rows = [t_engine.EngineRow(_tl(BERT64[:1])[0],
                               _t(SPECS["InFlex"]), 0)]
    plain = t_engine.run_batched_ga(rows, t_mapper.GAConfig(**BUDGET),
                                    device=CPU)
    want = j_engine.run_batched_ga(
        [j_engine.EngineRow(BERT64[0], SPECS["InFlex"], 0)],
        j_mapper.GAConfig(pipeline=True, **BUDGET))
    assert plain[0].best_obj == want[0].best_obj
    assert np.array_equal(plain[0].best_genome, want[0].best_genome)
    for cfg in (t_mapper.GAConfig(devices=2, **BUDGET),
                t_mapper.GAConfig(pipeline=True, **BUDGET)):
        got = t_engine.run_batched_ga(rows, cfg, device=CPU)
        assert got[0].best_obj == plain[0].best_obj
        assert got[0].history == plain[0].history
        assert np.array_equal(got[0].best_genome, plain[0].best_genome)


def test_hw_mismatch_and_warmup():
    a = _t(SPECS["FullFlex1111"])
    b = dataclasses.replace(a, hw=dataclasses.replace(a.hw, num_pes=256))
    layer = _tl(BERT64[:1])[0]
    with pytest.raises(ValueError, match="HWConfig"):
        t_engine.run_batched_ga([t_engine.EngineRow(layer, a, 0),
                                 t_engine.EngineRow(layer, b, 0)],
                                t_mapper.GAConfig(**BUDGET), device=CPU)
    t_engine.warmup_engine(t_mapper.GAConfig(**BUDGET), device=CPU)
