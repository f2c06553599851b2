"""The port's foundations against the JAX package: specs, class vectors,
map spaces and padded tables equal; GA draw streams byte-identical; the
torch ``xp`` operators equal to the numpy path (including an index walk to
-1, where ``torch.remainder`` must floor like ``np.mod``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import classes as j_classes  # noqa: E402
from repro.core import ga_ops as j_ga  # noqa: E402
from repro.core import mapspace as j_ms  # noqa: E402
from repro.core import spec as j_spec  # noqa: E402
from repro.core import workloads as j_wl  # noqa: E402
from repro.core.mapper import GAConfig as JGAConfig  # noqa: E402
from repro.core.result_cache import ResultCache as JCache  # noqa: E402

from repro_torch.core import classes as t_classes  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import envvars as t_env  # noqa: E402
from repro_torch.core import ga_ops as t_ga  # noqa: E402
from repro_torch.core import mapspace as t_ms  # noqa: E402
from repro_torch.core import workloads as t_wl  # noqa: E402
from repro_torch.core.mapper import GAConfig as TGAConfig  # noqa: E402
from repro_torch.core.result_cache import ResultCache as TCache  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

SPECS = [
    ("0000", j_spec.INFLEX), ("1111", j_spec.FULLFLEX),
    ("1111", j_spec.PARTFLEX), ("11111", j_spec.FULLFLEX),
    ("10101", j_spec.PARTFLEX), ("0110", j_spec.FULLFLEX),
]
LAYERS = [j_wl.get_model("bert")[0], j_wl.get_model("mnasnet")[28],
          j_wl.get_model("resnet50")[1], j_wl.get_model("alexnet")[0]]


def _pair(cls, level):
    js = j_spec.make_variant(cls, level)
    return js, convert.spec_from_dict(dataclasses.asdict(js))


def _tl(layer):
    return convert.layer_from_dict(dataclasses.asdict(layer))


def _cfg(**kw):
    return JGAConfig(**kw), TGAConfig(**kw)


@pytest.mark.parametrize("cls,level", SPECS)
def test_specs_tables_and_class_vectors_equal(cls, level):
    js, ts = _pair(cls, level)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.class_vector() == js.class_vector()
    assert ts.class_id() == js.class_id()
    assert ts.class_str() == js.class_str()
    assert hash(ts) == hash(convert.spec_from_dict(dataclasses.asdict(js)))
    jp, tp = j_ms.padded_tables(js), t_ms.padded_tables(ts)
    for a, b in zip(jp, tp):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_class_taxonomy_and_model_zoo_equal():
    assert t_classes.ALL_CLASSES == j_classes.ALL_CLASSES
    assert t_classes.ALL_CLASSES_5 == j_classes.ALL_CLASSES_5
    assert t_classes.PRIOR_WORK == j_classes.PRIOR_WORK
    for cid in range(32):
        assert t_classes.class_vector(cid, 5) == j_classes.class_vector(cid,
                                                                       5)
    assert set(t_wl.MODEL_ZOO) == set(j_wl.MODEL_ZOO)
    for name in j_wl.MODEL_ZOO:
        j_layers, t_layers = j_wl.get_model(name), t_wl.get_model(name)
        assert [dataclasses.asdict(l) for l in t_layers] == \
            [dataclasses.asdict(l) for l in j_layers]
        assert np.array_equal(t_wl.layers_as_array(t_layers),
                              j_wl.layers_as_array(j_layers))


@pytest.mark.parametrize("cls,level", SPECS)
def test_draw_streams_byte_identical(cls, level):
    js, ts = _pair(cls, level)
    jc, tc = _cfg(population=12, generations=5)
    for layer in LAYERS:
        jspace, tspace = j_ms.MapSpace(layer, js), t_ms.MapSpace(_tl(layer),
                                                                  ts)
        jr, tr = np.random.default_rng(3), np.random.default_rng(3)
        jp = j_ga.initial_population(jr, jspace, jc)
        tp = t_ga.initial_population(tr, tspace, tc)
        assert jp.dtype == tp.dtype and jp.tobytes() == tp.tobytes()
        jd = j_ga.draw_run(jr, jspace, jc, 5, 11)
        td = t_ga.draw_run(tr, tspace, tc, 5, 11)
        for f, a, b in zip(j_ga.GenDraws._fields, jd, td):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
        # the streams stay in lockstep afterwards
        assert jr.random() == tr.random()


@pytest.mark.parametrize("cls,level", SPECS)
def test_mapspace_sample_clip_decode_equal(cls, level):
    js, ts = _pair(cls, level)
    for layer in LAYERS:
        jspace, tspace = j_ms.MapSpace(layer, js), t_ms.MapSpace(_tl(layer),
                                                                  ts)
        g = jspace.sample(np.random.default_rng(1), 40)
        assert np.array_equal(g, tspace.sample(np.random.default_rng(1),
                                               40))
        raw = np.random.default_rng(2).integers(-5, 900, (40, 10))
        assert np.array_equal(jspace.clip(raw), tspace.clip(raw))
        assert np.array_equal(jspace.table_lens(), tspace.table_lens())
        for a, b in zip(jspace.decode_batch(g), tspace.decode_batch(g)):
            assert np.array_equal(a, b)
        for row in g[:8]:
            assert dataclasses.asdict(tspace.decode(row)) == \
                dataclasses.asdict(jspace.decode(row))
        assert tspace.axis_cardinalities() == jspace.axis_cardinalities()


def _draws_with_walk_to_minus_one(space, cfg, n):
    d = t_ga.single_generation_draws(np.random.default_rng(5), space, cfg, n)
    # force every index gene of child 0 to walk down from index 0
    m_idx = d.m_idx.copy()
    walk = d.walk.copy()
    stepdir = d.stepdir.copy()
    m_idx[0], walk[0], stepdir[0] = True, True, -1
    return d._replace(m_idx=m_idx, walk=walk, stepdir=stepdir)


@pytest.mark.parametrize("cls,level", SPECS)
def test_torch_operators_equal_numpy(cls, level):
    js, ts = _pair(cls, level)
    layer = _tl(LAYERS[0])
    space = t_ms.MapSpace(layer, ts)
    cfg = TGAConfig(population=24, generations=1)
    rng = np.random.default_rng(11)
    pop = space.clip(space.sample(rng, 24))
    n = 21
    parents = pop[rng.integers(0, 24, n)]
    parents[0, 6:10] = 0
    d = _draws_with_walk_to_minus_one(space, cfg, n)
    lens = space.table_lens()
    td = t_ga.GenDraws(*(torch.as_tensor(f) for f in d))
    T = t_ga.TORCH

    def t(a):
        return torch.as_tensor(a)

    cross_np = t_ga.apply_crossover(parents, d, np)
    cross_t = t_ga.apply_crossover(t(parents), td, T)
    assert np.array_equal(cross_np, cross_t.numpy())
    mut_np = t_ga.apply_mutation(parents, d, space.tile_lo, space.tile_hi,
                                 lens, np)
    mut_t = t_ga.apply_mutation(t(parents), td, t(space.tile_lo),
                                t(space.tile_hi), t(lens), T)
    assert np.array_equal(mut_np, mut_t.numpy())
    assert mut_np.dtype == np.int32 and mut_t.dtype == torch.int32
    # the walk to -1 wrapped to the end of each open table
    open_axes = lens > 1
    assert np.array_equal(mut_np[0, 6:10][open_axes], (lens - 1)[open_axes])
    # and the JAX package's numpy path agrees
    assert np.array_equal(
        mut_np, j_ga.apply_mutation(parents, d, space.tile_lo,
                                    space.tile_hi, lens, np))
    order_idx = np.argsort(rng.random(24), kind="stable")
    nxt_np = t_ga.next_population(pop, order_idx, d, space.tile_lo,
                                  space.tile_hi, lens, 3, np)
    nxt_t = t_ga.next_population(t(pop), t(order_idx), td,
                                 t(space.tile_lo), t(space.tile_hi),
                                 t(lens), 3, T)
    assert np.array_equal(nxt_np, nxt_t.numpy())
    assert np.array_equal(
        nxt_np, j_ga.next_population(pop, order_idx, d, space.tile_lo,
                                     space.tile_hi, lens, 3, np))


def test_torch_remainder_floors_like_numpy():
    idx = np.array([-1, -7, 0, 5, 13], np.int32)
    lens = np.array([4, 4, 4, 4, 4], np.int32)
    got = t_ga.TORCH.mod(torch.as_tensor(idx), torch.as_tensor(lens))
    assert np.array_equal(got.numpy(), np.mod(idx, lens))


def test_result_cache_semantics_equal():
    for cache in (JCache(maxsize=3), TCache(maxsize=3)):
        assert cache.merge("a", 1) == 1 and cache.merge("a", 2) == 1
        cache.put("b", 2)
        cache.put("c", 3)
        cache.get("a")
        cache.put("d", 4)                       # evicts LRU "b"
        assert cache.get("b") is None
        assert cache.merge_pair("x", 1, "y", 2) == (1, 2)
    assert TCache(maxsize=3).stats().keys() == JCache(maxsize=3).stats().keys()


def test_env_registry_rejects_unregistered_names(monkeypatch):
    monkeypatch.setenv("REPRO_NO_KERNELS", "1")
    assert t_env.get_env("REPRO_NO_KERNELS") == "1"
    with pytest.raises(KeyError):
        t_env.get_env("REPRO_NO_SUCH_KNOB")


def test_default_device_is_the_card():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)


def test_convert_round_trips_mappings_and_genomes():
    js = j_spec.make_variant("11111")
    jspace = j_ms.MapSpace(LAYERS[0], js)
    g = jspace.sample(np.random.default_rng(0), 6)
    tspace = t_ms.MapSpace(_tl(LAYERS[0]),
                           convert.spec_from_dict(dataclasses.asdict(js)))
    for row in g:
        m = convert.mapping_from_dict(dataclasses.asdict(jspace.decode(row)))
        assert np.array_equal(tspace.encode(m), jspace.encode(
            jspace.decode(row)))
    assert convert.genomes_from_numpy(g).dtype == np.int32
    assert convert.genomes_from_numpy(g, "cpu").dtype == torch.int32
    with pytest.raises(ValueError):
        convert.genomes_from_numpy(g[:, :9])
