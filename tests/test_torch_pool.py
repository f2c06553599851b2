"""The port's device pool and in-flight queue, on the CPU.

Mirrors tests/test_device_pool.py: the ``parse_device_spec`` grammar,
count clamping and index checks (a CPU call's pool is built over the one
CPU device), round-robin chunk placement, the ``GAConfig(devices=...)`` /
``REPRO_DEVICES`` resolution order and the queue's order and depth.  Then
the port's own checks: a pipelined, pooled campaign equals the plain one
and the JAX reference's campaign bit for bit, a failing chunk carries its
context and drains the queue, the fixed-genome replay and flexion give the
same results under ``REPRO_DEVICES=0,0``, and ``form_wave`` returns what
the reference's does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import mapper as j_mapper  # noqa: E402
from repro.core import spec as j_spec  # noqa: E402
from repro.core import workloads as j_wl  # noqa: E402
from repro.serve.engine import form_wave as j_form_wave  # noqa: E402

from repro_torch.core import convert  # noqa: E402
from repro_torch.core import engine as t_engine  # noqa: E402
from repro_torch.core import flexion_batched as t_fb  # noqa: E402
from repro_torch.core import mapper as t_mapper  # noqa: E402
from repro_torch.core import workloads as t_wl  # noqa: E402
from repro_torch.core.device_pool import default_pool, pool_for  # noqa: E402
from repro_torch.dist.pool import (DevicePool, InFlightQueue,  # noqa: E402
                                   parse_device_spec)
from repro_torch.serve.engine import form_wave as t_form_wave  # noqa: E402

CPU = torch.device("cpu")
GAConfig = t_mapper.GAConfig


def _t(spec):
    return convert.spec_from_dict(dataclasses.asdict(spec))


def _flat(results):
    return [(p.runtime, p.energy, p.edp, p.util, p.dram_elems, p.feasible,
             tuple(p.history), dataclasses.astuple(p.mapping))
            for r in results for p in r.per_layer]


# --------------------------------------------------------------------------
# spec grammar + resolution order
# --------------------------------------------------------------------------

def test_parse_device_spec_grammar():
    assert parse_device_spec(None) is None
    assert parse_device_spec("") is None
    assert parse_device_spec(3) == (0, 1, 2)
    assert parse_device_spec("2") == (0, 1)
    assert parse_device_spec("all") == ()
    assert parse_device_spec("0,2") == (0, 2)
    assert parse_device_spec((1, 0, 1)) == (1, 0, 1)   # duplicates kept
    for bad in (0, -1, "0,-2", (), True):
        with pytest.raises(ValueError):
            parse_device_spec(bad)


def test_pool_from_spec_clamps_counts_and_checks_indices_on_the_cpu():
    # a CPU call's pool holds the one CPU device: counts clamp to it
    for spec in (1, 64, "4", "all"):
        pool = DevicePool.from_spec(spec, CPU)
        assert pool.devices == (CPU,), spec
    assert DevicePool.from_spec(None, CPU) is None
    assert DevicePool.from_spec((0, 0), CPU).devices == (CPU, CPU)
    # explicit out-of-range index is the caller's error
    for spec in ((0, 1), "0,3", (2,)):
        with pytest.raises(ValueError, match="out of range"):
            DevicePool.from_spec(spec, CPU)


def test_round_robin_assignment_and_placement():
    pool = DevicePool(["a", "b", "c"])
    assert [pool.device_for(i) for i in range(7)] == \
        ["a", "b", "c", "a", "b", "c", "a"]
    cpu_pool = DevicePool([CPU, CPU])
    placed = cpu_pool.place((np.arange(3), [torch.ones(2)], 7), 1)
    assert isinstance(placed[0], torch.Tensor)
    assert placed[0].device == CPU and placed[1][0].device == CPU
    assert placed[2] == 7


def test_pool_resolution_order(monkeypatch):
    monkeypatch.delenv("REPRO_DEVICES", raising=False)
    assert pool_for(GAConfig(), CPU) is None     # nothing requested
    assert default_pool(CPU) is None
    monkeypatch.setenv("REPRO_DEVICES", "1")
    assert len(default_pool(CPU)) == 1
    assert len(pool_for(GAConfig(), CPU)) == 1   # env fallback
    # an explicit cfg wins over the env
    assert len(pool_for(GAConfig(devices=(0, 0)), CPU)) == 2
    monkeypatch.setenv("REPRO_DEVICES", "")      # empty = unset
    assert default_pool(CPU) is None


def test_gaconfig_devices_normalization():
    assert GAConfig().devices is None
    assert GAConfig(devices=4).devices == 4
    assert GAConfig(devices=[0, 1]).devices == (0, 1)
    assert GAConfig(devices="all").devices == "all"
    assert GAConfig(devices="0,2").devices == "0,2"
    assert GAConfig(devices=np.int64(2)).devices == 2
    # bad specs must fail AT CONSTRUCTION, not deep inside a chunk dispatch
    for bad in (0, -2, (), (0, -1), True, "bogus", "0,-2", "-1", 4.0):
        with pytest.raises(ValueError):
            GAConfig(devices=bad)


# --------------------------------------------------------------------------
# in-flight queue
# --------------------------------------------------------------------------

def test_in_flight_queue_ordering_and_depth():
    collected = []

    def collect(tag):
        collected.append(tag)
        return [f"r{tag}"]

    q = InFlightQueue(depth=2, collect=collect)
    out = []
    for tag in range(5):
        out.extend(q.push(tag))
        assert len(q) <= 2                       # never above the bound
    out.extend(q.drain())
    assert collected == [0, 1, 2, 3, 4]          # FIFO, submission order
    assert out == [f"r{t}" for t in range(5)]
    assert len(q) == 0
    with pytest.raises(ValueError):
        InFlightQueue(depth=0, collect=collect)


def test_in_flight_queue_keeps_new_entry_when_collect_raises():
    def exploding(tag):
        if tag == 0:
            raise RuntimeError("device error on chunk 0")
        return [tag]

    q = InFlightQueue(depth=1, collect=exploding)
    q.push(0)
    with pytest.raises(RuntimeError):
        q.push(1)                     # evicting chunk 0 fails...
    assert len(q) == 1                # ...but chunk 1 is still queued
    assert q.drain() == [1]


# --------------------------------------------------------------------------
# the engine over the pool
# --------------------------------------------------------------------------

def _two_chunk_requests():
    layers = t_wl.get_model("mnasnet") + t_wl.get_model("resnet50")
    specs = [_t(j_spec.make_variant("1111")),
             _t(j_spec.make_variant("1111", j_spec.PARTFLEX))]
    return [(layers, s) for s in specs]          # 120 unique rows


def test_engine_round_robins_chunks_over_the_pool(monkeypatch):
    seen = []
    real = t_engine._dispatch_chunk

    def recording(c, cfg, hw, device):
        seen.append(device)
        return real(c, cfg, hw, device)

    monkeypatch.setattr(t_engine, "_dispatch_chunk", recording)
    monkeypatch.delenv("REPRO_DEVICES", raising=False)
    cfg = GAConfig(population=4, generations=2, pipeline=True,
                   devices=(0, 0))               # 2-slot pool, one device
    t_mapper.search_campaign(_two_chunk_requests(), cfg, device=CPU)
    pool = pool_for(cfg, CPU)
    assert len(seen) >= 2                        # > ROW_BUCKET rows
    assert seen == [pool.devices[i % 2] for i in range(len(seen))]

    # no pool requested -> every chunk on the call's own device
    seen.clear()
    layers = t_wl.get_model("mnasnet")[:4]
    t_mapper.search_campaign([(layers, _t(j_spec.make_variant("1111")))],
                             GAConfig(population=4, generations=2),
                             device=CPU)
    assert seen == [CPU]


def test_pipelined_pooled_campaign_equals_plain_and_reference():
    kw = dict(population=6, generations=3, seed=1)
    specs = [j_spec.inflex_baseline(), j_spec.make_variant("1000"),
             j_spec.make_variant("1111", j_spec.PARTFLEX),
             j_spec.make_variant("11111")]
    reqs = [(m, s) for m in ("mnasnet", "alexnet") for s in specs]
    t_reqs = [(t_wl.get_model(m), _t(s)) for m, s in reqs]
    plain = _flat(t_mapper.search_campaign(t_reqs, GAConfig(**kw),
                                           device=CPU))
    assert len(plain) > t_engine.ROW_BUCKET       # several chunks
    for extra in (dict(pipeline=True), dict(devices=(0, 0)),
                  dict(pipeline=True, devices=(0, 0)),
                  dict(pipeline=True, devices=4)):
        got = _flat(t_mapper.search_campaign(
            t_reqs, GAConfig(**kw, **extra), device=CPU))
        assert got == plain, extra
    want = _flat(j_mapper.search_campaign(
        [(j_wl.get_model(m), s) for m, s in reqs],
        j_mapper.GAConfig(**kw, pipeline=True)))
    assert plain == want


@pytest.mark.parametrize("where", ["dispatch", "collect"])
def test_failing_chunk_carries_its_context_and_drains(monkeypatch, where):
    collected = []
    real_dispatch = t_engine._dispatch_chunk
    real_collect = t_engine._collect_chunk
    calls = {"dispatch": 0, "collect": 0}

    def dispatch(c, cfg, hw, device):
        calls["dispatch"] += 1
        if where == "dispatch" and calls["dispatch"] == 2:
            raise RuntimeError("device lost")
        return real_dispatch(c, cfg, hw, device)

    def collect(n_rows, gens, outputs):
        calls["collect"] += 1
        if where == "collect" and calls["collect"] == 1:
            raise RuntimeError("device lost")
        collected.append(n_rows)
        return real_collect(n_rows, gens, outputs)

    monkeypatch.setattr(t_engine, "_dispatch_chunk", dispatch)
    monkeypatch.setattr(t_engine, "_collect_chunk", collect)
    cfg = GAConfig(population=4, generations=2, pipeline=True,
                   devices=(0, 0))
    phase = "prepare/dispatch" if where == "dispatch" else "collection"
    with pytest.raises(RuntimeError, match=f"engine chunk .*{phase}") as e:
        t_mapper.search_campaign(_two_chunk_requests(), cfg, device=CPU)
    assert "device lost" in str(e.value.__cause__)
    if where == "dispatch":
        # chunk 0 was in flight when chunk 1 failed: it was collected
        assert collected == [t_engine.ROW_BUCKET]
    else:
        # chunk 0's collection failed during the drain; chunk 1 was still
        # collected before the error propagated
        assert calls["collect"] == 2 and len(collected) == 1


def test_replay_and_flexion_equal_under_a_pool(monkeypatch):
    spec = _t(j_spec.make_variant("1111"))
    genome = np.asarray([64, 16, 3, 3, 3, 3, 5, 7, 11, 0], np.int32)
    reqs = [(t_wl.get_model(m), spec, genome)
            for m in ("mnasnet", "resnet50", "alexnet")]
    rows = [(_t(j_spec.make_variant(c)), layer, 0)
            for c in ("1000", "1111") for layer in t_wl.get_model("ncf")]
    monkeypatch.setenv("REPRO_FLEXION_BACKEND", "torch")
    runs = []
    for env in (None, "0,0"):
        if env is None:
            monkeypatch.delenv("REPRO_DEVICES", raising=False)
        else:
            monkeypatch.setenv("REPRO_DEVICES", env)
            assert len(default_pool(CPU)) == 2
        t_fb.clear_flexion_reference_cache()
        runs.append((
            _flat(t_mapper.evaluate_fixed_genome_many(reqs, device=CPU)),
            [(r.hf, r.wf, r.per_axis_hf, r.per_axis_wf)
             for r in t_fb.flexion_campaign(rows, mc_samples=3000,
                                            device=CPU)]))
    assert runs[0] == runs[1]
    assert len(runs[0][0]) > t_engine.ROW_BUCKET  # the replay had chunks


@pytest.mark.parametrize("max_count", [1, 3, 8])
def test_form_wave_matches_reference(max_count):
    rng = np.random.default_rng(max_count)
    sizes = [int(v) for v in rng.integers(1, 9, 12)]
    limit = 10

    def fits_alone(x):
        return x <= 7

    def fits_with(wave, x):
        return sum(wave) + x <= limit

    tq, jq = list(sizes), list(sizes)
    while tq or jq:
        got = t_form_wave(tq, max_count, fits_alone, fits_with)
        want = j_form_wave(jq, max_count, fits_alone, fits_with)
        assert got == want and tq == jq
        assert got[0] or got[1]                   # progress


def test_trace_overlap_counts_preparation_under_kernels():
    """The pipeline trace's reading: preparation time under the union of
    kernel spans, and the card's idle share over the traced window."""
    from repro_torch.bench.pipeline_trace import trace_overlap

    def ev(name, cat, ts, dur):
        return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur)

    events = [ev("k", "kernel", 0, 40), ev("k", "kernel", 30, 20),
              ev("k", "kernel", 80, 20),
              ev("prepare_chunk", "user_annotation", 40, 60),
              ev("prepare_chunk", "cpu_op", 0, 100)]
    got = trace_overlap(events, 0.5)
    # kernels busy [0, 50) and [80, 100): 70 of 100 us; preparation
    # [40, 100) runs under kernels for 10 + 20 us
    assert "host preparation 0.1 ms, 0.0 ms of it (50.0%)" in got
    assert "3 kernels, card busy 0.1 ms of 0.1 ms traced" in got
    assert "idle share 30.0%" in got
    assert trace_overlap(events[3:], 0.5) == "no kernels in the trace"
