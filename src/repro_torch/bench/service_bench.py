"""DSE service bench: N concurrent overlapping clients vs N sequential
campaigns (the counterpart of ``benchmarks/service_bench.py``).

Each client runs the same 3-query session against one shared
:class:`~repro_torch.serve.dse_service.DSEService`:

  1. the *shared* query — every client asks for the same (model, spec)
     design point, so its rows dedup across clients into ONE engine
     dispatch;
  2. a *distinct* query — a per-client spec variant of the same model (same
     HWConfig, different flexibility class), which packs into shared waves
     with everyone else's rows;
  3. a *repeat* of the shared query — answered from the result cache with
     no dispatch at all.

The sequential baseline runs the identical 3N campaigns back-to-back
through ``search_campaign`` (every client pays for every row).  The service
must return bit-identical results (``parity_ok``), dispatch exactly the
unique row set (``unique_rows``, ``repeat_cached_ok``) and, with 4
clients, beat the baseline by the dedup/cache factor
(``_speedup_vs_sequential``, a timing sidecar; the deterministic keys are
the anchors, timings are not).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

from ..core import get_model, make_variant
from ..core.engine import row_cache_key
from ..core.mapper import plan_model_rows, request_rows, search_campaign
from ..serve import DSEService
from .common import BUDGETS, Table, bench_mode

# per-client spec variants: same HWConfig (one wave group), different
# flexibility classes — rows pack together but never dedup across specs
CLIENT_CLASSES = ("1110", "1101", "1011", "0111", "1100", "0011")

N_LAYERS_BY_MODE = {"fast": 6, "default": 10, "full": 16}


def _queries(n_clients: int, mode: str):
    """The (client, [(layers, spec), ...]) sessions — deterministic."""
    layers = get_model("mnasnet")[:N_LAYERS_BY_MODE[mode]]
    shared = make_variant("1111")
    sessions = []
    for i in range(n_clients):
        mine = make_variant(CLIENT_CLASSES[i % len(CLIENT_CLASSES)])
        sessions.append([(layers, shared), (layers, mine),
                         (layers, shared)])
    return sessions


def _bit_equal(a, b) -> bool:
    if (a.runtime, a.energy, a.edp) != (b.runtime, b.energy, b.edp):
        return False
    return all(x.runtime == y.runtime and x.energy == y.energy
               and x.history == y.history
               for x, y in zip(a.per_layer, b.per_layer))


def run(mode: Optional[str] = None, clients: int = 4, device=None,
        print_fn=print, devices=None) -> dict:
    """``devices`` is the engine's device pool on both sides (a
    ``GAConfig.devices`` spec; ``None``: the call's device)."""
    mode = bench_mode(mode)
    # both sides run the pipelined batched engine, so the speedup measures
    # the SERVICE — dedup, cross-request packing, cache — not an engine A/B
    cfg = dataclasses.replace(BUDGETS[mode], engine="batched",
                              pipeline=True, devices=devices)
    sessions = _queries(clients, mode)

    # the deterministic contract: the union of row-cache keys is exactly
    # what the service may dispatch (each key once, repeats never)
    unique_rows = len({
        row_cache_key(r, cfg)
        for session in sessions
        for layers, spec in session
        for r in request_rows(layers, spec, cfg,
                              plan_model_rows(layers)[0])})

    # bring the device up outside the timed region
    search_campaign([sessions[0][0]], cfg, device=device)

    t0 = time.time()
    baseline = [[search_campaign([pair], cfg, device=device)[0]
                 for pair in session]
                for session in sessions]
    t_sequential = time.time() - t0

    got = [[None] * len(s) for s in sessions]
    errs = []
    with DSEService(device=device) as svc:

        def client(i):
            try:
                for j, (layers, spec) in enumerate(sessions[i]):
                    got[i][j] = svc.query(layers, spec, cfg, timeout=600)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errs.append(e)

        t0 = time.time()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t_service = time.time() - t0
        stats = svc.stats()
        cache = svc.cache.stats()
    if errs:
        raise errs[0]

    parity_ok = all(_bit_equal(g, w)
                    for grow, wrow in zip(got, baseline)
                    for g, w in zip(grow, wrow))
    # every key dispatched at most once => repeats (and cross-client
    # duplicates) were cache/dedup-served
    repeat_cached_ok = stats["rows_dispatched"] == unique_rows

    speedup = t_sequential / max(t_service, 1e-9)
    n_queries = sum(len(s) for s in sessions)

    table = Table(f"DSE service: {clients} clients x "
                  f"{len(sessions[0])} queries",
                  ["metric", "sequential", "service"])
    table.add("wall_s", round(t_sequential, 3), round(t_service, 3))
    table.add("rows_run", stats["rows_planned"], stats["rows_dispatched"])
    table.add("queries_per_s", round(n_queries / max(t_sequential, 1e-9), 2),
              round(n_queries / max(t_service, 1e-9), 2))
    table.show(print_fn)
    print_fn(f"speedup_vs_sequential: {speedup:.2f}x  parity_ok: "
             f"{parity_ok}  cache: {cache['hits']} hits / "
             f"{cache['misses']} misses")

    return {
        "clients": clients,
        "queries_per_client": len(sessions[0]),
        "parity_ok": parity_ok,
        "repeat_cached_ok": repeat_cached_ok,
        "unique_rows": unique_rows,
        # timings and load-dependent counters are sidecars: measurements,
        # not anchors
        "_speedup_vs_sequential": round(speedup, 2),
        "_throughput_qps": round(n_queries / max(t_service, 1e-9), 2),
        "_rows_planned": stats["rows_planned"],
        "_rows_dispatched": stats["rows_dispatched"],
        "_cache_hits": cache["hits"],
        "_cache_misses": cache["misses"],
        "_phases": {"sequential": round(t_sequential, 6),
                    "service": round(t_service, 6)},
    }
