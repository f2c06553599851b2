"""The rest of the port's DSE against the JAX package: the campaign and
multi-spec searches, the fixed-genome replay and the fixed-config search
(bit-identical to the serial and batched engines and to the reference),
the flexion estimators (float64 numpy path equal to the reference's numpy
path, the float32 torch backend equal to the reference's float32 jax
backend), the area model, ``run_dse`` and the future-proofing study, all
at small sizes on the CPU."""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import area_model as j_area  # noqa: E402
from repro.core import dse as j_dse  # noqa: E402
from repro.core import flexion_batched as j_fb  # noqa: E402
from repro.core import mapper as j_mapper  # noqa: E402
from repro.core import spec as j_spec  # noqa: E402
from repro.core import workloads as j_wl  # noqa: E402

from repro_torch.core import area_model as t_area  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import dse as t_dse  # noqa: E402
from repro_torch.core import flexion as t_flex  # noqa: E402
from repro_torch.core import flexion_batched as t_fb  # noqa: E402
from repro_torch.core import mapper as t_mapper  # noqa: E402
from repro_torch.core import workloads as t_wl  # noqa: E402

CPU = "cpu"
KW = dict(population=8, generations=3, seed=5)
# raw genome: baseline-ish tiles + arbitrary (mod-table) O/P/S/R indices
GENOME = np.asarray([64, 16, 3, 3, 3, 3, 5, 7, 11, 0], np.int32)
SPECS = [("1111", j_spec.FULLFLEX), ("1111", j_spec.PARTFLEX),
         ("0000", j_spec.FULLFLEX), ("11111", j_spec.FULLFLEX),
         ("1000", j_spec.PARTFLEX), ("0110", j_spec.FULLFLEX)]


def _t(spec):
    return convert.spec_from_dict(dataclasses.asdict(spec))


def _j(cls, level=j_spec.FULLFLEX, **kw):
    return j_spec.make_variant(cls, level, **kw)


def _row(r):
    """A MapperResult as plain data (mapping included)."""
    return (dataclasses.asdict(r.mapping), r.runtime, r.energy, r.edp,
            r.util, r.dram_elems, r.feasible, list(r.history))


def _same_model(t_res, j_res):
    assert t_res.runtime == j_res.runtime
    assert t_res.energy == j_res.energy
    assert [_row(r) for r in t_res.per_layer] == \
        [_row(r) for r in j_res.per_layer]


# --------------------------------------------------------------------------
# campaign and multi-spec search
# --------------------------------------------------------------------------

def test_campaign_equals_serial_batched_and_reference():
    reqs = [("ncf", _j("1111")), ("dlrm", _j("1111", j_spec.PARTFLEX)),
            ("ncf", _j("11111")), ("dlrm", j_spec.inflex_baseline())]
    camp = t_mapper.search_campaign(
        [(t_wl.get_model(m), _t(s)) for m, s in reqs],
        t_mapper.GAConfig(**KW), device=CPU)
    j_camp = j_mapper.search_campaign(
        [(j_wl.get_model(m), s) for m, s in reqs], j_mapper.GAConfig(**KW))
    for (m, s), got, want in zip(reqs, camp, j_camp):
        _same_model(got, want)
        for engine in ("batched", "serial"):
            solo = t_mapper.search_model(
                t_wl.get_model(m), _t(s),
                t_mapper.GAConfig(engine=engine, **KW), device=CPU)
            _same_model(solo, got)


def test_search_specs_batched_matches_per_spec():
    layers = t_wl.get_model("ncf")
    specs = [_t(_j("1111")), _t(_j("0110")), _t(_j("1000",
                                                    j_spec.PARTFLEX))]
    cfg = t_mapper.GAConfig(**KW)
    multi = t_mapper.search_specs_batched(layers, specs, cfg, device=CPU)
    j_multi = j_mapper.search_specs_batched(
        j_wl.get_model("ncf"), [_j("1111"), _j("0110"),
                                _j("1000", j_spec.PARTFLEX)],
        j_mapper.GAConfig(**KW))
    for spec, got, want in zip(specs, multi, j_multi):
        _same_model(got, want)
        _same_model(t_mapper.search_model(layers, spec, cfg, device=CPU),
                    got)


def test_empty_campaigns_return_empty():
    cfg = t_mapper.GAConfig(**KW)
    layers = t_wl.get_model("ncf")
    assert t_mapper.search_campaign([], cfg, device=CPU) == []
    assert t_mapper.search_specs_batched(layers, [], cfg, device=CPU) == []
    assert t_mapper.evaluate_fixed_genome_many([], device=CPU) == []
    assert t_dse.run_dse(layers, [], cfg, device=CPU) == []
    assert t_dse.run_dse(layers, [], cfg, with_flexion=True,
                         device=CPU) == []
    out = t_mapper.search_campaign(
        [([], _t(j_spec.inflex_baseline())),
         (layers, _t(j_spec.inflex_baseline()))], cfg, device=CPU)
    assert out[0].per_layer == [] and out[0].runtime == 0.0
    assert out[1].per_layer and out[1].runtime > 0.0


# --------------------------------------------------------------------------
# fixed-genome replay and fixed-config search
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model", sorted(j_wl.MODEL_ZOO))
def test_fixed_genome_replay_matches_reference(model):
    for cls, level in SPECS[:2] + SPECS[3:4]:
        js = _j(cls, level)
        want = j_mapper.evaluate_fixed_genome(j_wl.get_model(model), js,
                                              GENOME)
        got = t_mapper.evaluate_fixed_genome(t_wl.get_model(model), _t(js),
                                             GENOME, device=CPU)
        _same_model(got, want)
        assert got.runtime == float(sum(r.runtime for r in got.per_layer))


def test_many_model_replay_matches_per_model_calls():
    spec = _t(_j("1111"))
    names = sorted(j_wl.MODEL_ZOO)
    many = t_mapper.evaluate_fixed_genome_many(
        [(t_wl.get_model(m), spec, GENOME) for m in names], device=CPU)
    for name, combined in zip(names, many):
        _same_model(combined, t_mapper.evaluate_fixed_genome(
            t_wl.get_model(name), spec, GENOME, device=CPU))


@pytest.mark.parametrize("objective", ["runtime", "energy", "edp"])
def test_fixed_config_objective_bit_identical(objective):
    """The stacked objective is the reference's jitted program bit for bit
    (including the order of its float32 layer sum), on every model."""
    import jax.numpy as jnp

    for cls, level in SPECS[:4]:
        js = _j(cls, level)
        for model in ("mnasnet", "resnet50", "bert"):
            cfg = j_mapper.GAConfig(population=16, generations=2)
            st = j_mapper._fixed_config_state(j_wl.get_model(model), js, cfg)
            t, o, p, sh, r = st.space.decode_batch(st.pop)
            r_live = bool((r != 8).any())
            want = np.asarray(j_mapper._fixed_configs_objective(
                st.dims[None], st.strides[None], st.dws[None],
                st.mask[None], *(jnp.asarray(a[None]) for a in (t, o, p,
                                                                 sh)),
                jnp.asarray(r[None]) if r_live else None, hw=js.hw,
                hard_partition=st.space.hard_partition, objective=objective))
            up = torch.as_tensor
            got = t_mapper._fixed_configs_objective(
                up(st.dims[None]), up(st.strides[None]), up(st.dws[None]),
                up(st.mask[None]), *(up(a[None]) for a in (t, o, p, sh)),
                up(r[None]) if r_live else None, js.hw,
                st.space.hard_partition, objective).numpy()
            assert np.array_equal(got, want), (cls, level, model)


def test_fixed_config_search_matches_reference_and_solo():
    hw = j_spec.HWConfig()
    names = ["ncf", "alexnet", "dlrm"]
    j_reqs = [(j_wl.get_model(m), j_spec.FlexSpec(name=f"probe-{m}", hw=hw))
              for m in names]
    t_reqs = [(t_wl.get_model(m), _t(s)) for m, (_, s) in zip(names,
                                                               j_reqs)]
    j_out = j_mapper.search_fixed_configs(j_reqs, j_mapper.GAConfig(**KW))
    t_out = t_mapper.search_fixed_configs(t_reqs, t_mapper.GAConfig(**KW),
                                          device=CPU)
    for (layers, spec), (tg, tr), (jg, jr) in zip(t_reqs, t_out, j_out):
        assert np.array_equal(tg, jg)
        _same_model(tr, jr)
        sg, sr = t_mapper.search_fixed_config(layers, spec,
                                              t_mapper.GAConfig(**KW),
                                              device=CPU)
        assert np.array_equal(sg, tg)
        _same_model(sr, tr)


# --------------------------------------------------------------------------
# flexion
# --------------------------------------------------------------------------

FLEX_LAYERS = [j_wl.get_model("mnasnet")[0], j_wl.get_model("alexnet")[0],
               j_wl.get_model("mnasnet")[1], j_wl.get_model("bert")[0],
               None]
MC = 3000


def _report(rep):
    return convert.flexion_report_from_dict(dataclasses.asdict(rep))


def _tl(layer):
    return None if layer is None else convert.layer_from_dict(
        dataclasses.asdict(layer))


def _flex_rows():
    return [(_j(cls, level), layer) for cls, level in SPECS
            for layer in FLEX_LAYERS]


def test_flexion_numpy_path_equals_reference(monkeypatch):
    monkeypatch.delenv("REPRO_FLEXION_BACKEND", raising=False)
    rows = _flex_rows()
    j_fb.clear_flexion_reference_cache()
    t_fb.clear_flexion_reference_cache()
    j_camp = j_fb.flexion_campaign(rows, mc_samples=MC, seed=7)
    t_camp = t_fb.flexion_campaign([(_t(s), _tl(l)) for s, l in rows],
                                   mc_samples=MC, seed=7, device=CPU)
    assert t_camp == [_report(r) for r in j_camp]
    # row i == the single-row wrapper with the campaign's seed convention
    for i, (spec, layer) in enumerate(rows[::5]):
        i *= 5
        assert t_flex.compute_flexion(_t(spec), _tl(layer), mc_samples=MC,
                                      seed=7 + i, ref_seed=7,
                                      device=CPU) == t_camp[i]


def test_flexion_torch_backend_equals_reference_float32_backend(
        monkeypatch):
    rows = [(s, l, 0) for s, l in _flex_rows()]
    monkeypatch.setenv("REPRO_FLEXION_BACKEND", "jax")
    j_fb.clear_flexion_reference_cache()
    j_camp = j_fb.flexion_campaign(rows, mc_samples=MC, seed=0)
    monkeypatch.setenv("REPRO_FLEXION_BACKEND", "numpy")
    j_np = j_fb.flexion_campaign(rows, mc_samples=MC, seed=0)
    monkeypatch.setenv("REPRO_FLEXION_BACKEND", "torch")
    t_fb.clear_flexion_reference_cache()
    t_camp = t_fb.flexion_campaign([(_t(s), _tl(l), w) for s, l, w in rows],
                                   mc_samples=MC, seed=0, device=CPU)
    assert t_camp == [_report(r) for r in j_camp]
    # float32 counts move the fractions off the float64 ones only slightly
    for got, want in zip(t_camp, j_np):
        assert got.hf == pytest.approx(want.hf, rel=1e-5, abs=1e-12)
        assert got.wf == pytest.approx(want.wf, rel=1e-5, abs=1e-12)


def test_flexion_backend_follows_device_and_env(monkeypatch):
    monkeypatch.delenv("REPRO_FLEXION_BACKEND", raising=False)
    assert t_fb._backend(torch.device("cpu")) == "numpy"
    assert t_fb._backend(torch.device("cuda")) == "torch"
    monkeypatch.setenv("REPRO_FLEXION_BACKEND", "numpy")
    assert t_fb._backend(torch.device("cuda")) == "numpy"
    monkeypatch.setenv("REPRO_FLEXION_BACKEND", "torch")
    assert t_fb._backend(torch.device("cpu")) == "torch"


def test_model_flexion_campaign_matches_reference_and_wrapper():
    requests = [(_j("1111", j_spec.PARTFLEX), j_wl.get_model("ncf")),
                (_j("1000"), j_wl.get_model("dlrm")),
                (_j("0000"), j_wl.get_model("ncf"))]
    j_camp = j_fb.model_flexion_campaign(requests, mc_samples=2000, seed=3)
    t_req = [(_t(s), t_wl.get_model(m))
             for (s, _), m in zip(requests, ("ncf", "dlrm", "ncf"))]
    t_camp = t_fb.model_flexion_campaign(t_req, mc_samples=2000, seed=3,
                                         device=CPU)
    assert t_camp == [_report(r) for r in j_camp]
    for (spec, layers), rep in zip(t_req, t_camp):
        assert rep == t_flex.model_flexion(spec, layers, mc_samples=2000,
                                           seed=3, device=CPU)
    with pytest.raises(ValueError, match="no layers"):
        t_fb.model_flexion_campaign([(t_req[0][0], [])], device=CPU)


def test_flexion_bounded_on_the_192_combo_domain():
    """Every fraction lies in [0, 1]: 16 classes x {PartFlex, FullFlex} x 3
    layer kinds x 2 HWConfigs (the paper baseline and a 2 KB buffer)."""
    class_strs = ["".join(b) for b in itertools.product("01", repeat=4)]
    layers = [_tl(FLEX_LAYERS[i]) for i in (0, 2, 1)]
    rows = [(_t(_j(cs, level, hw=hw)), layer, 0)
            for hw in (j_spec.HWConfig(), j_spec.HWConfig(buffer_bytes=2048))
            for cs in class_strs
            for level in (j_spec.PARTFLEX, j_spec.FULLFLEX)
            for layer in layers]
    assert len(rows) == 192
    for rep in t_fb.flexion_campaign(rows, mc_samples=1000, seed=0,
                                     device=CPU):
        for v in (rep.hf, rep.wf, *rep.per_axis_hf.values(),
                  *rep.per_axis_wf.values()):
            assert 0.0 <= v <= 1.0
        assert rep.hf == float(np.prod(list(rep.per_axis_hf.values())))


def test_paired_hf_bound_and_layer_count_invariance():
    spec = _t(_j("1000", j_spec.PARTFLEX,
                 hw=j_spec.HWConfig(buffer_bytes=128)))
    for seed in range(10):
        rep = t_flex.compute_flexion(spec, mc_samples=500, seed=seed,
                                     device=CPU)
        assert 0.0 <= rep.per_axis_hf["T"] <= 1.0
    spec = _t(_j("1000", j_spec.PARTFLEX))
    layers = t_wl.get_model("ncf")
    one = t_flex.model_flexion(spec, layers[:1], mc_samples=2000,
                               device=CPU)
    full = t_flex.model_flexion(spec, layers, mc_samples=2000, device=CPU)
    assert one.hf == full.hf == t_flex.compute_flexion(
        spec, mc_samples=2000, device=CPU).hf


# --------------------------------------------------------------------------
# area, run_dse, the future-proofing study
# --------------------------------------------------------------------------

def test_area_of_equals_reference_for_every_class():
    for cls in ["".join(b) for b in itertools.product("01", repeat=5)]:
        for level in (j_spec.PARTFLEX, j_spec.FULLFLEX):
            for hw in (j_spec.HWConfig(), j_spec.HWConfig(num_pes=256,
                                                          bytes_per_elem=2)):
                js = _j(cls, level, hw=hw)
                assert dataclasses.asdict(t_area.area_of(_t(js))) == \
                    dataclasses.asdict(j_area.area_of(js))


def test_run_dse_matches_reference():
    cands = [j_spec.inflex_baseline(), _j("1111"), _j("1100"),
             _j("1111", j_spec.PARTFLEX)]
    cfg = dict(population=6, generations=2)
    for engine in ("batched", "serial"):
        j_rows = j_dse.run_dse(j_wl.get_model("ncf"), cands,
                               j_mapper.GAConfig(engine=engine, **cfg),
                               with_flexion=True, flexion_samples=2000)
        t_rows = t_dse.run_dse(t_wl.get_model("ncf"),
                               [_t(c) for c in cands],
                               t_mapper.GAConfig(engine=engine, **cfg),
                               with_flexion=True, flexion_samples=2000,
                               device=CPU)
        assert [r.row() for r in t_rows] == [r.row() for r in j_rows]


def test_freeze_and_open_axes_match_reference():
    hw = j_spec.HWConfig()
    probe = j_spec.FlexSpec(name="probe-ncf", hw=hw)
    for g in (GENOME, np.asarray([3, 900, 2, 1, 7, 1, 100, 3, 40, 2])):
        js = j_dse.freeze_spec_from_genome(probe, j_wl.get_model("ncf"),
                                           g, "frozen")
        ts = t_dse.freeze_spec_from_genome(_t(probe), t_wl.get_model("ncf"),
                                           g, "frozen")
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        for cs in ("1000", "0101", "1111", "00001", "11111"):
            for level in (j_spec.PARTFLEX, j_spec.FULLFLEX):
                assert dataclasses.asdict(t_dse.open_axes(ts, cs, level)) \
                    == dataclasses.asdict(j_dse.open_axes(js, cs, level))
    assert t_dse.geomean_speedup({"r": {"a": 0.5, "b": 0.125}}, "r") == \
        j_dse.geomean_speedup({"r": {"a": 0.5, "b": 0.125}}, "r")


@pytest.mark.parametrize("campaign", [False, True])
def test_future_proofing_study_matches_reference(campaign):
    kw = dict(base_model="ncf", future_models=("ncf", "dlrm", "bert"),
              class_strs=("1000", "0011", "1111", "11111"),
              campaign=campaign, flexion_samples=2000)
    cfg = dict(population=6, generations=2)
    j_t, j_h, j_w = {}, {}, {}
    want = j_dse.future_proofing_study(
        cfg=j_mapper.GAConfig(**cfg), timings=j_t, flexion=j_h,
        wflexion=j_w, **kw)
    t_t, t_h, t_w = {}, {}, {}
    got = t_dse.future_proofing_study(
        cfg=t_mapper.GAConfig(**cfg), timings=t_t, flexion=t_h,
        wflexion=t_w, device=CPU, **kw)
    assert got == want
    assert t_h == j_h and t_w == j_w
    assert set(t_t) == set(j_t)
    other = t_dse.future_proofing_study(
        cfg=t_mapper.GAConfig(**cfg), device=CPU,
        **dict(kw, campaign=not campaign))
    assert other == got
