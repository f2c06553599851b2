"""DSE-as-a-service: a concurrent campaign server with cross-request
batching and a persistent result cache (the counterpart of
``repro/serve/dse_service.py``).

Many clients submit ``(model layers, FlexSpec, GAConfig)`` queries
concurrently, and a single dispatcher thread packs whatever is pending into
campaign waves (admission through :func:`~repro_torch.serve.engine.
form_wave`):

  * **cross-request batching** — each query is planned with the one
    campaign convention (``mapper.plan_model_rows`` dedup +
    ``cfg.seed + 1000 * first_occurrence_index`` seeds), then ALL queries of
    a wave that share an HWConfig and GA parameters concatenate into ONE
    ``run_batched_ga`` row set.  The cost model makes every
    (layer, spec, seed) row independent, so rows from *different* clients
    legally share engine chunks — and rows with equal
    :func:`~repro_torch.core.engine.row_cache_key` dispatch once for the
    whole wave.
  * **persistent result cache** — a thread-safe, size-bounded,
    hit/miss-counted :class:`~repro_torch.core.result_cache.ResultCache`
    keyed by the canonical ``(GA params, spec, workload, seed)`` row key
    answers repeat queries without any engine dispatch; ``save``/``load``
    make it survive restarts.  :meth:`DSEService.cache_stats` also reports
    the flexion caches (the same store class).
  * **device placement** — every wave runs on the service's ``device``
    (``None``: the CUDA card), passed explicitly into ``run_batched_ga``:
    torch's current device and stream are per thread, so the dispatcher
    thread never relies on them.  Wave row sets can spread over a device
    pool (``devices=`` at construction, else the query's
    ``GAConfig.devices``, else ``REPRO_DEVICES``), chunk-pipelined by
    default.
  * **fault tolerance** — a wave whose engine dispatch dies (a failed
    device surfaces as the chunk-contextualized RuntimeError from
    ``run_batched_ga``) is retried up to ``max_retries`` times; a
    :class:`~repro_torch.runtime.ft.HeartbeatMonitor` tracks dispatcher
    liveness and a :class:`~repro_torch.runtime.ft.FaultInjector` can
    script failures for tests.  An error on the dispatcher thread rejects
    the tickets of its wave group and leaves the service running.

**Bit-parity guarantee**: every answer equals a direct
``search_campaign([(layers, spec)], cfg, device=device)`` call for that
request — at any client count, wave packing, pool size or cache state.  It
holds by construction: the service reuses ``plan_model_rows`` /
``assemble_model_result`` verbatim, a wave never puts queries whose specs
take the width-scaled cost graph (an open or off-native R table) in one
engine pass with queries whose specs do not, so a row's result depends only
on its row key, and placement/scheduling knobs never change results.  (The
reference groups by ``(HWConfig, GA params)`` alone, so its waves can mix
the two and move R-pinned energies in the last bit.)
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence

from ..core.engine import (ga_params_key, row_cache_key, run_batched_ga,
                           spec_scales_width)
from ..core.flexion_batched import flexion_cache_stats
from ..core.mapper import (GAConfig, ModelResult, assemble_model_result,
                           plan_model_rows, request_rows)
from ..core.result_cache import ResultCache
from ..core.spec import FlexSpec
from ..core.workloads import Layer
from ..device import resolve_device
from ..runtime.ft import FaultInjector, HeartbeatMonitor
from .engine import form_wave


class DSETicket:
    """Handle for one submitted query; ``result()`` blocks until the
    dispatcher resolves it (or re-raises its failure)."""

    def __init__(self, uid: int):
        self.uid = uid
        self._done = threading.Event()
        self._result: Optional[ModelResult] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> ModelResult:
        if not self._done.wait(timeout):
            raise TimeoutError(f"query {self.uid} not done after "
                               f"{timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    # dispatcher side
    def _resolve(self, value: ModelResult) -> None:
        self._result = value
        self._done.set()

    def _reject(self, err: BaseException) -> None:
        self._error = err
        self._done.set()


@dataclasses.dataclass
class _Query:
    """One admitted request, row-planned at submit time so admission can
    count rows and the dispatcher never re-derives the plan."""

    uid: int
    layers: List[Layer]
    spec: FlexSpec
    cfg: GAConfig
    dedup: bool
    ticket: DSETicket
    row_index: List[int] = dataclasses.field(default_factory=list)
    seen: Dict[tuple, int] = dataclasses.field(default_factory=dict)
    rows: List = dataclasses.field(default_factory=list)
    keys: frozenset = frozenset()

    @property
    def group_key(self) -> tuple:
        # rows may share ONE run_batched_ga call iff they share an HWConfig
        # (one hw per chunk), the GA parameters that determine row results
        # and the cost graph (a chunk with a width-scaled row scales them
        # all, which moves pinned rows' energies in the last bit); per-query
        # seeds live on the rows themselves
        return (self.spec.hw, ga_params_key(self.cfg),
                spec_scales_width(self.spec))


class DSEService:
    """Concurrent campaign server over the batched mapper stack.

    ``query``/``submit`` are thread-safe; all engine work happens on one
    dispatcher thread, which loops: admit a wave of pending queries
    (``form_wave``), group by ``(HWConfig, GA params, width scaling)``, run
    each group's
    concatenated rows through ``run_batched_ga(..., row_cache=cache,
    device=device)``, assemble and resolve tickets.

    Parameters
    ----------
    cache : ResultCache, optional — the persistent row store (callers may
        share one across services or pre-``load`` a saved cache).
    max_wave_queries / max_wave_rows : admission bounds; a single query
        planning more than ``max_wave_rows`` unique rows is rejected with a
        per-query error instead of stalling every other client.
    max_retries : engine-dispatch retries per wave group before the
        group's clients see the error.
    devices / pipeline : forwarded onto each group's execution GAConfig —
        pure placement/scheduling, results unchanged.
    fault_injector : scripted dispatch faults for tests; ``check`` is
        called with a monotonically increasing dispatch sequence number.
    device : where the engine runs (``None``: the CUDA card; without one
        the constructor raises).
    """

    def __init__(self, cache: Optional[ResultCache] = None,
                 max_wave_queries: int = 64,
                 max_wave_rows: int = 1024,
                 max_retries: int = 2,
                 devices=None,
                 pipeline: bool = True,
                 heartbeat_timeout_s: float = 600.0,
                 fault_injector: Optional[FaultInjector] = None,
                 device=None):
        if max_wave_rows < 1 or max_wave_queries < 1:
            raise ValueError("wave bounds must be >= 1")
        self.device = resolve_device(device)
        self.cache = cache if cache is not None else ResultCache()
        self.max_wave_queries = int(max_wave_queries)
        self.max_wave_rows = int(max_wave_rows)
        self.max_retries = int(max_retries)
        self.devices = devices
        self.pipeline = bool(pipeline)
        self.heartbeat = HeartbeatMonitor(1, timeout_s=heartbeat_timeout_s)
        self._injector = fault_injector

        self._pending: List[_Query] = []
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self._uid = 0
        self._dispatch_seq = 0
        self._stats = {"queries": 0, "waves": 0, "groups": 0,
                       "rows_planned": 0, "rows_dispatched": 0,
                       "retries": 0, "rejected": 0}
        self._thread = threading.Thread(target=self._serve_loop,
                                        name="dse-service", daemon=True)
        self._thread.start()

    # -- client side --------------------------------------------------------

    def submit(self, layers: Sequence[Layer], spec: FlexSpec,
               cfg: Optional[GAConfig] = None,
               dedup: bool = True) -> DSETicket:
        """Enqueue one (model, spec, GAConfig) query; returns a ticket whose
        ``result()`` is bit-identical to
        ``search_campaign([(layers, spec)], cfg, dedup=dedup)[0]``."""
        cfg = cfg or GAConfig()
        layers = list(layers)
        with self._wake:
            if self._closed:
                raise RuntimeError("DSEService is closed")
            self._uid += 1
            q = _Query(uid=self._uid, layers=layers, spec=spec, cfg=cfg,
                       dedup=dedup, ticket=DSETicket(self._uid))
            q.row_index, q.seen = plan_model_rows(layers, dedup)
            q.rows = request_rows(layers, spec, cfg, q.row_index)
            q.keys = frozenset(row_cache_key(r, cfg) for r in q.rows)
            self._stats["queries"] += 1
            self._stats["rows_planned"] += len(q.rows)
            self._pending.append(q)
            self._wake.notify_all()
        return q.ticket

    def query(self, layers: Sequence[Layer], spec: FlexSpec,
              cfg: Optional[GAConfig] = None, dedup: bool = True,
              timeout: Optional[float] = None) -> ModelResult:
        """Synchronous ``submit().result()``."""
        return self.submit(layers, spec, cfg, dedup).result(timeout)

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain pending queries, then stop the dispatcher."""
        with self._wake:
            self._closed = True
            self._wake.notify_all()
        self._thread.join(timeout)

    def __enter__(self) -> "DSEService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._stats)
        out["healthy"] = self.heartbeat.healthy()
        return out

    def cache_stats(self) -> Dict[str, Dict]:
        """Hit/miss/size report of every store the service touches: its own
        mapper row cache plus the process-wide flexion caches."""
        return {"mapper_rows": self.cache.stats(), **flexion_cache_stats()}

    # -- dispatcher side ----------------------------------------------------

    def _fits_alone(self, q: _Query) -> bool:
        return len(q.keys) <= self.max_wave_rows

    def _fits_with(self, wave: Sequence[_Query], q: _Query) -> bool:
        keys = set(q.keys)
        for w in wave:
            keys |= w.keys
        return len(keys) <= self.max_wave_rows

    def _serve_loop(self) -> None:
        while True:
            with self._wake:
                while not self._pending and not self._closed:
                    self._wake.wait()
                if not self._pending and self._closed:
                    return
                wave, rejected = form_wave(self._pending,
                                           self.max_wave_queries,
                                           self._fits_alone,
                                           self._fits_with)
                self._stats["waves"] += 1
                self._stats["rejected"] += len(rejected)
            for q in rejected:
                q.ticket._reject(ValueError(
                    f"query {q.uid}: {len(q.keys)} unique rows exceed the "
                    f"service admission bound max_wave_rows="
                    f"{self.max_wave_rows}; split the model/spec sweep "
                    f"into smaller queries"))
            if wave:
                self._run_wave(wave)
                self.heartbeat.beat(0)

    def _run_wave(self, wave: List[_Query]) -> None:
        groups: Dict[tuple, List[_Query]] = {}
        for q in wave:
            groups.setdefault(q.group_key, []).append(q)
        with self._lock:
            self._stats["groups"] += len(groups)
        for group in groups.values():
            try:
                self._run_group(group)
            except BaseException as e:  # noqa: BLE001 - clients must not hang
                for q in group:
                    if not q.ticket.done():
                        q.ticket._reject(e)
                if not isinstance(e, Exception):
                    raise               # interrupt / exit: stop the loop

    def _run_group(self, group: List[_Query]) -> None:
        """One engine pass for every row of every query in the group —
        cross-request packing happens HERE: the concatenated rows flow into
        ``run_batched_ga`` where equal-key rows (across clients) dispatch
        once and cached rows not at all."""
        all_rows = [r for q in group for r in q.rows]
        # placement/scheduling only — never changes results
        exec_cfg = dataclasses.replace(
            group[0].cfg, engine="batched", pipeline=self.pipeline,
            devices=self.devices if self.devices is not None
            else group[0].cfg.devices)
        fresh = {k for q in group for k in q.keys
                 if not self.cache.contains(k)}

        attempt = 0
        while True:
            try:
                if self._injector is not None:
                    seq = self._dispatch_seq
                    self._dispatch_seq += 1
                    self._injector.check(seq)
                results = run_batched_ga(all_rows, exec_cfg,
                                         row_cache=self.cache,
                                         device=self.device)
                break
            except RuntimeError as e:
                # a failed device poisons its chunk: run_batched_ga drains
                # the in-flight queue and raises with chunk context; rows
                # are deterministic, so a restart is bit-identical (bounded
                # by max_retries)
                attempt += 1
                with self._lock:
                    self._stats["retries"] += 1
                if attempt > self.max_retries:
                    raise RuntimeError(
                        f"wave group failed after {attempt} attempts "
                        f"({self.max_retries} retries): {e}") from e

        with self._lock:
            self._stats["rows_dispatched"] += len(fresh)
        pos = 0
        for q in group:
            chunk = results[pos:pos + len(q.rows)]
            pos += len(q.rows)
            try:
                q.ticket._resolve(assemble_model_result(
                    q.layers, q.spec, q.row_index, q.seen, chunk, q.dedup))
            except Exception as e:  # noqa: BLE001 - isolate per query
                q.ticket._reject(e)
