"""The port's lock orders at run time, on the CPU: the counterpart of
tests/test_dse_service.py's runtime cross-check for the reference.

The four real locks of the port are wrapped in tests/_lockorder.py's
recording proxies while concurrent clients drive the port's DSEService
(and ``cache_stats``' flexion-table pass); every (held, then-acquired)
order a thread actually took must be in the static REP007 graph that
``repro_torch.analysis.locksets.lock_order_edges`` derives for
``src/repro_torch``.  If call-graph resolution ever misses an acquisition
path, the runtime edges drift outside the static set and this fails.
"""
import threading
import types
from pathlib import Path

import pytest

pytest.importorskip("torch")

from _lockorder import LockOrderRecorder  # noqa: E402

from repro_torch.analysis.locksets import lock_order_edges  # noqa: E402
from repro_torch.analysis.walker import Project  # noqa: E402
from repro_torch.core import flexion_batched as fb  # noqa: E402
from repro_torch.core import workloads as wl  # noqa: E402
from repro_torch.core.mapper import GAConfig, search_campaign  # noqa: E402
from repro_torch.core.result_cache import ResultCache  # noqa: E402
from repro_torch.core.spec import make_variant  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.serve import dse_service  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TABLE_LOCK_ID = "repro_torch.core.flexion_batched._TABLE_LOCK"
RESULT_CACHE_LOCK_ID = "repro_torch.core.result_cache.ResultCache._lock"
DSE_SERVICE_LOCK_ID = "repro_torch.serve.dse_service.DSEService._lock"
BUILD_LOCK_ID = "repro_torch.kernels._build._LOCK"
CFG = GAConfig(population=8, generations=3, seed=0)
SPEC = make_variant("1111")


def _models():
    a = [wl.conv("a1", 16, 8, 14, 14, 3, 3),
         wl.conv("a2", 16, 8, 14, 14, 3, 3),
         wl.conv("a3", 32, 16, 7, 7, 1, 1)]
    b = [wl.conv("b1", 16, 8, 14, 14, 3, 3),
         wl.dwconv("b2", 16, 14, 14, 3, 3)]
    return [a, b, a[1:], b[:1]]


def test_runtime_lock_orders_subset_of_static_lock_graph(monkeypatch):
    static = lock_order_edges(Project.load(REPO, ["src/repro_torch"]))
    rec = LockOrderRecorder()
    # module globals resolved by name at call time
    monkeypatch.setattr(fb, "_TABLE_LOCK",
                        rec.wrap(TABLE_LOCK_ID, threading.Lock()))
    monkeypatch.setattr(_build, "_LOCK",
                        rec.wrap(BUILD_LOCK_ID, threading.Lock()))
    # DSEService._lock: the service module's threading.Lock() returns a
    # recording proxy, which its Condition wraps
    shim = types.SimpleNamespace(
        Lock=rec.lock_factory(DSE_SERVICE_LOCK_ID),
        RLock=threading.RLock, Condition=threading.Condition,
        Thread=threading.Thread, Event=threading.Event)
    monkeypatch.setattr(dse_service, "threading", shim)
    cache = ResultCache()
    rec.wrap_instance_lock(cache, RESULT_CACHE_LOCK_ID)

    models = _models()
    got, errs = [None] * len(models), []
    with dse_service.DSEService(cache=cache, device="cpu") as svc:
        def client(i):
            try:
                got[i] = svc.query(models[i], SPEC, CFG, timeout=300)
            except BaseException as e:  # noqa: BLE001 - reported below
                errs.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(models))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert not errs, errs
        svc.cache_stats()               # holds _TABLE_LOCK over the memos

    named = {TABLE_LOCK_ID, RESULT_CACHE_LOCK_ID, DSE_SERVICE_LOCK_ID,
             BUILD_LOCK_ID}
    observed = {(a, b) for a, b in rec.edges if a in named and b in named}
    assert observed <= static, (
        f"runtime lock orders {sorted(observed - static)} not in the "
        f"static REP007 graph {sorted(static)}")
    # the recorder really saw the locks work (the build lock is taken only
    # where a kernel is built, on the card)
    assert {DSE_SERVICE_LOCK_ID, RESULT_CACHE_LOCK_ID,
            TABLE_LOCK_ID} <= rec.acquired
    # and the service still answered like a solo campaign
    for layers, res in zip(models, got):
        want = search_campaign([(layers, SPEC)], CFG, device="cpu")[0]
        assert res.edp == want.edp and res.runtime == want.runtime
