"""The port's DSE service on the CPU, against the JAX package.

Mirrors tests/test_dse_service.py: concurrent clients answered bit for bit
like the reference's solo ``search_campaign``, repeat queries served from
the cache without a dispatch, the cache across restarts, a poisoned
dispatch retried, exhausted retries rejecting clients but not the service,
admission control, ``cache_stats`` and the row key; the ``ResultCache``
store tests the foundations do not already hold; the fault-tolerance
helpers the service uses; and the port's service bench against the
anchors pinned in ``BENCH_mapper.json``.
"""
import dataclasses
import json
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core import mapper as j_mapper  # noqa: E402
from repro.core import spec as j_spec  # noqa: E402
from repro.core import workloads as j_wl  # noqa: E402

from repro_torch.bench import service_bench  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import result_cache as rc_mod  # noqa: E402
from repro_torch.core.engine import row_cache_key  # noqa: E402
from repro_torch.core.mapper import (GAConfig, plan_model_rows,  # noqa: E402
                                     request_rows, search_campaign)
from repro_torch.core.result_cache import ResultCache  # noqa: E402
from repro_torch.runtime.ft import (FaultInjector,  # noqa: E402
                                    HeartbeatMonitor, StragglerDetector)
from repro_torch.serve import DSEService  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
KW = dict(population=8, generations=3, seed=0)
CFG = GAConfig(**KW)
J_SPEC = j_spec.make_variant("1111")
SPEC = convert.spec_from_dict(dataclasses.asdict(J_SPEC))


def _j_model_a():
    # a1 == a2 by shape -> dedups within the request
    return [j_wl.conv("a1", 16, 8, 14, 14, 3, 3),
            j_wl.conv("a2", 16, 8, 14, 14, 3, 3),
            j_wl.conv("a3", 32, 16, 7, 7, 1, 1)]


def _j_model_b():
    # b1 shares a1's shape AND first-occurrence seed -> dedups ACROSS
    # requests
    return [j_wl.conv("b1", 16, 8, 14, 14, 3, 3),
            j_wl.dwconv("b2", 16, 14, 14, 3, 3)]


def _tl(layers):
    return [convert.layer_from_dict(dataclasses.asdict(l)) for l in layers]


def _model_a():
    return _tl(_j_model_a())


def _model_b():
    return _tl(_j_model_b())


def _reference(j_layers, **kw):
    """The JAX package's solo campaign for one request."""
    return j_mapper.search_campaign([(j_layers, J_SPEC)],
                                    j_mapper.GAConfig(**kw))[0]


def _assert_same(got, want):
    """Bit-identical ModelResults (floats compared with ==)."""
    assert got.runtime == want.runtime
    assert got.energy == want.energy
    assert got.edp == want.edp
    assert len(got.per_layer) == len(want.per_layer)
    for g, w in zip(got.per_layer, want.per_layer):
        assert g.runtime == w.runtime and g.energy == w.energy
        assert g.feasible == w.feasible
        assert g.history == w.history
        assert dataclasses.astuple(g.mapping) == \
            dataclasses.astuple(w.mapping)


def _service(**kw):
    return DSEService(device=CPU, **kw)


# -- service ---------------------------------------------------------------


def test_concurrent_clients_bit_identical_to_reference_solo_campaign():
    """N client threads, overlapping models, distinct GA seeds: every answer
    must equal the reference's search_campaign for that request alone."""
    requests = [(_j_model_a(), dict(KW)),
                (_j_model_b(), dict(KW)),
                (_j_model_a(), dict(KW, seed=11)),
                (_j_model_b(), dict(KW, seed=11, objective="energy"))]
    want = [_reference(layers, **kw) for layers, kw in requests]

    with _service() as svc:
        got = [None] * len(requests)
        errs = []

        def client(i):
            layers, kw = requests[i]
            try:
                got[i] = svc.query(_tl(layers), SPEC, GAConfig(**kw),
                                   timeout=300)
            except BaseException as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        assert not errs, errs
        for g, w in zip(got, want):
            _assert_same(g, w)
        stats = svc.stats()
    assert stats["queries"] == len(requests)
    # within- and cross-request dedup: fewer rows dispatched than planned
    assert stats["rows_dispatched"] < stats["rows_planned"]
    assert stats["healthy"]


class _Gate:
    """A fault injector that holds the first engine dispatch until
    ``release`` is set, so queries submitted meanwhile meet in one wave."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def check(self, step):
        if step == 0:
            self.entered.set()
            assert self.release.wait(300)


def test_width_scaled_and_pinned_clients_in_one_wave_match_solo_campaigns():
    """A PartFlex-1111 client (R pinned to the native width) and a
    FullFlex-11111 client (R open) admitted in one wave: each answer equals
    the reference's solo campaign.  A chunk that holds an R-open row costs
    every row with width scaling, which moves this layer's pinned energy in
    the last bit, so the service must not pack the two into one pass."""
    from repro.core import dse as j_dse
    j_base = j_spec.make_variant("0000")
    j_specs = [j_dse.open_axes(j_base, "1111", j_spec.PARTFLEX),
               j_dse.open_axes(j_base, "11111", j_spec.FULLFLEX)]
    specs = [convert.spec_from_dict(dataclasses.asdict(s)) for s in j_specs]
    layers = [j_wl.conv("e", 480, 80, 14, 14, 1, 1)]
    want = [j_mapper.search_campaign([(layers, s)],
                                     j_mapper.GAConfig(**KW))[0]
            for s in j_specs]
    # the packing this guards against does move the pinned answer
    mixed = search_campaign([(_tl(layers), s) for s in specs], CFG,
                            device=CPU)
    assert mixed[0].energy != want[0].energy

    gate = _Gate()
    with _service(fault_injector=gate) as svc:
        blocker = svc.submit(_model_a(), SPEC, CFG)
        assert gate.entered.wait(300)
        tickets = [svc.submit(_tl(layers), s, CFG) for s in specs]
        gate.release.set()
        blocker.result(timeout=300)
        got = [t.result(timeout=300) for t in tickets]
        stats = svc.stats()
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert stats["waves"] == 2          # the blocker's, then both clients'
    assert stats["groups"] == 3         # the mixed wave split in two


def test_repeat_query_served_from_cache_without_dispatch():
    with _service() as svc:
        first = svc.query(_model_a(), SPEC, CFG, timeout=300)
        dispatched = svc.stats()["rows_dispatched"]
        misses = svc.cache.stats()["misses"]
        again = svc.query(_model_a(), SPEC, CFG, timeout=300)
        _assert_same(again, first)
        assert svc.stats()["rows_dispatched"] == dispatched
        assert svc.cache.stats()["misses"] == misses
        assert svc.cache.stats()["hits"] > 0


def test_cache_persists_across_service_restarts(tmp_path):
    path = str(tmp_path / "rows.pkl")
    with _service() as svc:
        want = svc.query(_model_a(), SPEC, CFG, timeout=300)
        svc.cache.save(path)
    cache = ResultCache()
    cache.load(path)
    with _service(cache=cache) as svc2:
        got = svc2.query(_model_a(), SPEC, CFG, timeout=300)
        _assert_same(got, want)
        assert svc2.stats()["rows_dispatched"] == 0


def test_poisoned_dispatch_retries():
    """The first engine dispatch raises (the shape a failed device takes
    after run_batched_ga drains its in-flight queue); the service retries
    and still answers bit-identically."""
    want = _reference(_j_model_b(), **KW)
    with _service(fault_injector=FaultInjector((0,))) as svc:
        got = svc.query(_model_b(), SPEC, CFG, timeout=300)
        _assert_same(got, want)
        assert svc.stats()["retries"] == 1


def test_retries_exhausted_rejects_clients_not_service():
    with _service(fault_injector=FaultInjector((0, 1)),
                  max_retries=1) as svc:
        with pytest.raises(RuntimeError, match="after 2 attempts"):
            svc.query(_model_b(), SPEC, CFG, timeout=300)
        # the dispatcher survives a failed wave: next query still runs
        want = _reference(_j_model_a(), **KW)
        _assert_same(svc.query(_model_a(), SPEC, CFG, timeout=300), want)


def test_oversized_query_rejected_with_progress():
    with _service(max_wave_rows=1) as svc:
        with pytest.raises(ValueError, match="max_wave_rows"):
            svc.query(_model_a(), SPEC, CFG, timeout=60)
        small = [j_wl.conv("s", 8, 8, 7, 7, 3, 3)]
        want = _reference(small, **KW)
        _assert_same(svc.query(_tl(small), SPEC, CFG, timeout=300), want)
        assert svc.stats()["rejected"] == 1


def test_submit_after_close_raises():
    svc = _service()
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(_model_a(), SPEC, CFG)


def test_service_needs_a_card_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DSEService()


def test_cache_stats_reports_all_stores():
    with _service() as svc:
        svc.query(_model_a(), SPEC, CFG, timeout=300)
        stats = svc.cache_stats()
    assert set(stats) >= {"mapper_rows", "reference", "order", "pair",
                          "shape", "repr"}
    assert stats["mapper_rows"]["misses"] > 0


def _rows(layers, cfg):
    row_index, _ = plan_model_rows(layers)
    return request_rows(layers, SPEC, cfg, row_index)


def test_row_cache_key_excludes_names_and_placement():
    cfg1 = GAConfig(population=8, generations=3, engine="serial",
                    pipeline=False)
    cfg2 = GAConfig(population=8, generations=3, engine="batched",
                    pipeline=True, devices=2)
    rows1 = _rows(_model_a(), cfg1)
    rows2 = _rows(_tl([j_wl.conv("other-name", 16, 8, 14, 14, 3, 3),
                       j_wl.conv("x", 16, 8, 14, 14, 3, 3),
                       j_wl.conv("y", 32, 16, 7, 7, 1, 1)]), cfg2)
    assert [row_cache_key(r, cfg1) for r in rows1] == \
           [row_cache_key(r, cfg2) for r in rows2]


# -- ResultCache store -----------------------------------------------------


def test_result_cache_lru_bound_and_counters():
    c = ResultCache(maxsize=2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1          # touch: a becomes most-recent
    c.put("c", 3)                   # evicts b
    assert c.get("b") is None
    assert c.get("a") == 1 and c.get("c") == 3
    s = c.stats()
    assert s["evictions"] == 1 and s["misses"] == 1 and s["hits"] == 3
    assert len(c) == 2


def test_result_cache_half_present_pair_reads_as_a_miss():
    c = ResultCache(maxsize=64)
    assert c.get_pair("s", "h") is None
    assert c.merge_pair("s", 10, "h", 20) == (10, 20)
    assert c.get_pair("s", "h") == (10, 20)
    # a half-present pair reads as a miss, and merge replaces BOTH halves
    c2 = ResultCache(maxsize=64)
    c2.put("s", 10)
    assert c2.get_pair("s", "h") is None
    assert c2.merge_pair("s", 99, "h", 20) == (99, 20)
    assert c2.get_pair("s", "h") == (99, 20)


def test_result_cache_thread_safety_under_contention():
    c = ResultCache(maxsize=128)

    def worker(seed):
        for i in range(200):
            k = (seed * 7 + i) % 64
            got = c.merge(k, k * 2)
            assert got == k * 2     # value is a pure function of the key
            c.get(k)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    s = c.stats()
    assert s["size"] <= 128
    assert s["hits"] + s["misses"] == 8 * 200


def test_interrupted_save_leaves_previous_snapshot_intact(tmp_path,
                                                          monkeypatch):
    import pickle as _pickle

    path = str(tmp_path / "rows.pkl")
    cache = ResultCache()
    cache.put("k", 1)
    assert cache.save(path) == 1
    cache.put("k2", 2)

    def _dump_partial_then_die(items, f):
        f.write(b"\x80\x04corrupt")          # truncated-pickle prefix
        raise OSError("disk full mid-save")

    monkeypatch.setattr(rc_mod.pickle, "dump", _dump_partial_then_die)
    with pytest.raises(OSError):
        cache.save(path)
    monkeypatch.setattr(rc_mod.pickle, "dump", _pickle.dump)

    assert sorted(p.name for p in tmp_path.iterdir()) == ["rows.pkl"]
    fresh = ResultCache()
    assert fresh.load(path) == 1
    assert fresh.get("k") == 1


# -- fault tolerance helpers ------------------------------------------------


def test_straggler_detector():
    det = StragglerDetector(n_workers=4, factor=2.0)
    for _ in range(8):
        for w in range(4):
            det.record(w, 1.0 if w != 2 else 3.5)
    assert det.stragglers() == [2]


def test_heartbeat_monitor():
    clock = [0.0]
    mon = HeartbeatMonitor(3, timeout_s=10.0, clock=lambda: clock[0])
    clock[0] = 5.0
    mon.beat(0)
    mon.beat(1)
    clock[0] = 12.0
    assert mon.dead() == [2]
    mon.beat(2)
    assert mon.healthy()


def test_fault_injector_fires_once_per_step():
    inj = FaultInjector((1, 3))
    inj.check(0)
    with pytest.raises(RuntimeError, match="step 1"):
        inj.check(1)
    inj.check(1)                    # once each
    with pytest.raises(RuntimeError, match="step 3"):
        inj.check(3)


# -- the service bench -----------------------------------------------------


def test_service_bench_reproduces_committed_anchors():
    with open(REPO / "BENCH_mapper.json") as f:
        want = json.load(f)["engines"]["batched"]["service"]["derived"]
    got = service_bench.run(mode="fast", device=CPU,
                            print_fn=lambda *a, **k: None)
    for key in ("clients", "queries_per_client", "parity_ok",
                "repeat_cached_ok", "unique_rows"):
        assert got[key] == want[key], key
    assert got["_rows_dispatched"] == got["unique_rows"]
    # the service's answers equal the sequential campaigns, which equal
    # the reference's solo campaigns on the same sessions
    layers = j_wl.get_model("mnasnet")[:service_bench.N_LAYERS_BY_MODE[
        "fast"]]
    solo = search_campaign([(_tl(layers), SPEC)],
                           dataclasses.replace(service_bench.BUDGETS["fast"],
                                               pipeline=True), device=CPU)[0]
    _assert_same(solo, j_mapper.search_campaign(
        [(layers, J_SPEC)], j_mapper.GAConfig(population=24,
                                              generations=10))[0])
