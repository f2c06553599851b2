"""Batched Monte-Carlo flexion campaign: every tile-fit estimate in one
vectorized evaluation.

The campaign packs all requested estimates the way ``search_campaign``
packs MSE rows:

  * every distinct ``(dims, seed)`` **sample stream** is drawn once
    (host-side numpy Generators) into a dim-major ``(D, 6, N)`` tensor, and
    every distinct ``(draw, stride, depthwise, buf)`` **evaluation job**
    runs once over its draw;
  * both buffer predicates (hard-partitioned and soft) are evaluated on the
    **same** samples in one vectorized pass — float64 numpy on the host for
    a CPU device, float32 torch on the caller's CUDA device
    (``REPRO_FLEXION_BACKEND=numpy|torch`` forces a backend);
  * the workload-agnostic reference fractions are memoized in a
    process-wide cache keyed by ``(hw, hard, n, seed, backend)``, so C_X is
    sampled once per HWConfig.

Paired sampling keeps the PartFlex H-F estimate inside [0, 1]: per draw the
hard predicate (each operand <= buf/3) implies the soft one (sum <= buf),
so ``p_hard <= p_soft`` and the ratio ``|A_X| / |C_X|`` cannot exceed 1.

``compute_flexion`` / ``model_flexion`` in ``flexion.py`` are thin
single-row wrappers over ``_campaign`` below, so serial and batched results
are bit-identical by construction (boolean means are exact counts, so
stacking rows cannot change them).  The torch path counts in float32: it
matches the JAX package's float32 backend, not its float64 numpy path.
"""
from __future__ import annotations

import functools
import threading
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..device import device_program, resolve_device
from ..dist.pool import InFlightQueue
from .device_pool import pool_of
from .envvars import get_env
from .result_cache import ResultCache
from .spec import (FULLFLEX, FlexSpec, INFLEX, PARTFLEX,
                   RepresentationSpec)
from .workloads import C, K, Layer, NUM_DIMS, R, S, X, Y

# Workload-agnostic C_X sample domain (paper Sec 4.1): tiles uniform over
# [1, 256]^4 x [1, 11]^2 — filters are small in practice.
AGNOSTIC_DMAX = 256
AGNOSTIC_RS = 11

# rows per vectorized evaluation chunk are capped so the stacked float64
# sample tensor stays ~200MB even at paper-scale mc_samples
_CHUNK_SAMPLES = 4_000_000

# (hw, hard, n, seed, backend) -> workload-agnostic tile-fit fraction.  The
# hard and soft entries for a key prefix come from ONE paired sample draw,
# and are read/written as an atomic PAIR, so a concurrent campaign never
# observes a half-populated soft/hard reference.  The backend is part of
# the key: float32 counts never stand in for float64 ones.
_REF_CACHE = ResultCache(maxsize=4096)

# the exact-table memos below are shared by every thread; one lock makes
# each count compute exactly once and keeps cache_clear atomic with respect
# to in-flight lookups
_TABLE_LOCK = threading.Lock()


def _locked_memo(fn):
    """``lru_cache`` guarded by ``_TABLE_LOCK`` (shared by all four table
    counters), exposing ``cache_clear``/``cache_info`` like the bare memo."""
    cached = lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def wrapper(*args):
        with _TABLE_LOCK:
            return cached(*args)

    wrapper.cache_clear = cached.cache_clear
    wrapper.cache_info = cached.cache_info
    return wrapper


def clear_flexion_reference_cache() -> None:
    """Drop ALL memoized flexion state — the C_X reference fractions and
    the exact O/P/S/R table counts — so benchmark timings really start
    cache-cold; results never depend on cache state."""
    _REF_CACHE.clear()
    with _TABLE_LOCK:
        _order_count.cache_clear()
        _pair_count.cache_clear()
        _shape_count.cache_clear()
        _repr_count.cache_clear()


def flexion_cache_stats() -> Dict[str, Dict[str, int]]:
    """Hit/miss/size counters of every memoized flexion store: the C_X
    ``reference`` pair cache plus the four exact-table count memos — the
    flexion half of ``DSEService.cache_stats()``."""
    with _TABLE_LOCK:
        tables = {name: {"hits": fn.cache_info().hits,
                         "misses": fn.cache_info().misses,
                         "size": fn.cache_info().currsize}
                  for name, fn in (("order", _order_count),
                                   ("pair", _pair_count),
                                   ("shape", _shape_count),
                                   ("repr", _repr_count))}
    return {"reference": _REF_CACHE.stats(), **tables}


def _agnostic_dims() -> np.ndarray:
    dims = np.full(NUM_DIMS, AGNOSTIC_DMAX, np.int64)
    dims[R] = dims[S] = AGNOSTIC_RS
    return dims


def _agnostic_volume() -> float:
    return float(np.prod(_agnostic_dims().astype(np.float64)))


# The exact O/P/S axis counts only depend on the (hashable, frozen) axis
# specs, but materializing the tables — FullFlex shape_table walks all
# num_pes row counts — costs more than the whole MC evaluation when done
# per row, so the counts are memoized (lock-guarded: concurrent campaigns
# share them).
@_locked_memo
def _order_count(order) -> int:
    return len(order.order_table())


@_locked_memo
def _pair_count(parallel) -> int:
    return len(parallel.pair_table())


@_locked_memo
def _shape_count(shape, num_pes: int) -> int:
    return len(shape.shape_table(num_pes))


@_locked_memo
def _repr_count(representation, default_bits: int) -> int:
    return len(representation.bits_table(default_bits))


def _default_reference(spec: FlexSpec) -> FlexSpec:
    """The FullFlex-T/O/P/S reference accelerator for H-F, with the R axis
    *mirroring the spec's openness*: a pinned-R spec is measured against a
    pinned-R reference (ratio exactly 1.0 — the paper's 4-axis H-F values
    are preserved bit-identically), while an R-open spec is measured against
    the FullFlex-R domain.  Pass an explicit 5-axis FullFlex ``reference`` to
    compare pinned and open R classes on one scale (the fig13 32-class
    sweep's monotonicity tests do)."""
    if spec.representation.is_flexible:
        return FlexSpec(hw=spec.hw,
                        representation=RepresentationSpec(flex=FULLFLEX))
    return FlexSpec(hw=spec.hw)


BACKENDS = ("numpy", "torch")


def _backend(device: torch.device) -> str:
    """The predicate backend: ``REPRO_FLEXION_BACKEND`` when set, else
    float32 torch on a CUDA device and float64 numpy on the host."""
    forced = get_env("REPRO_FLEXION_BACKEND", "")
    if forced in BACKENDS:
        return forced
    return "torch" if device.type == "cuda" else "numpy"


def _draw_tiles(dims: np.ndarray, rng: np.random.Generator, n: int,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """(6, n) float64 uniform tile draws over prod[1, d_i] — one
    ``integers`` call per dim, the serial estimator's exact stream, written
    straight into the (possibly shared) dim-major float64 tensor (the
    int64→float64 cast is exact for these ranges; dim-major keeps every
    per-dim predicate slice contiguous)."""
    t = np.empty((NUM_DIMS, n), np.float64) if out is None else out
    for d in range(NUM_DIMS):
        t[d] = rng.integers(1, dims[d] + 1, n)
    return t


def _pair_fractions(t, stride, depthwise, buf, xp):
    """Soft and hard buffer-fit fractions of each row's samples, (J,) each.

    ``t`` (J, 6, N) dim-major tile draws (each ``t[:, dim]`` slice is
    contiguous); ``stride`` / ``depthwise`` / ``buf`` (J,).  Both predicates
    are evaluated on the SAME samples: per draw, the hard predicate implies
    the soft one, which is what keeps the PartFlex H-F ratio inside [0, 1].
    """
    stride_b = stride[:, None]
    dw_b = depthwise[:, None]
    buf_b = buf[:, None]
    in_y = (t[:, Y] - 1) * stride_b + t[:, R]
    in_x = (t[:, X] - 1) * stride_b + t[:, S]
    vol_in = t[:, C] * in_y * in_x
    k_eff = xp.where(dw_b, xp.ones_like(t[:, K]), t[:, K])
    vol_w = k_eff * t[:, C] * t[:, R] * t[:, S]
    c_out = xp.where(dw_b, t[:, C], t[:, K])
    vol_out = c_out * t[:, Y] * t[:, X]
    soft = (vol_in + vol_w + vol_out) <= buf_b
    hard = ((vol_in <= buf_b / 3) & (vol_w <= buf_b / 3)
            & (vol_out <= buf_b / 3))
    # boolean means are exact counts (float64 on numpy, float32 on torch)
    return xp.mean(soft, axis=1), xp.mean(hard, axis=1)


class _TorchXP:
    """The three array functions ``_pair_fractions`` takes from its ``xp``,
    on torch tensors.  A boolean mean is the exact float32 count times the
    float32 constant 1/N: XLA rewrites the reference's division by N that
    way, and the two round differently."""

    where = staticmethod(torch.where)
    ones_like = staticmethod(torch.ones_like)

    @staticmethod
    def mean(a, axis):
        inv_n = float(np.float32(1.0) / np.float32(a.shape[axis]))
        return a.to(torch.float32).sum(dim=axis) * inv_n


_TORCH = _TorchXP()


@device_program("backend", "device")
def _eval_jobs(t: np.ndarray, draw_idx: np.ndarray, stride: np.ndarray,
               depthwise: np.ndarray, buf: np.ndarray, backend: str,
               device: torch.device):
    """Evaluate each job's predicates over its draw slice of the stacked
    (D, 6, N) sample tensor (``draw_idx`` maps jobs to draws); returns
    (p_soft, p_hard) per job.  The torch path returns float32 tensors on
    ``device`` without waiting for them (the caller materializes them, so
    later chunks' host draws overlap the device's work)."""
    if backend == "torch":
        # one (J, 6, N) float32 batch on the device, as the reference's
        # float32 backend evaluates it (no job padding: nothing is jitted)
        def up(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        return _pair_fractions(
            up(t[draw_idx]), up(stride),
            torch.as_tensor(np.asarray(depthwise, bool), device=device),
            up(buf), _TORCH)
    # numpy path: one vectorized evaluation per job over its (no-copy) draw
    # view — the (N,) working set stays cache-resident (means are per-row,
    # so the results are identical either way)
    j = len(draw_idx)
    soft = np.empty(j, np.float64)
    hard = np.empty(j, np.float64)
    dw = depthwise.astype(bool)
    for i in range(j):
        d = draw_idx[i]
        s_i, h_i = _pair_fractions(t[d:d + 1], stride[i:i + 1], dw[i:i + 1],
                                   buf[i:i + 1], np)
        soft[i], hard[i] = s_i[0], h_i[0]
    return soft, hard


class _Jobs:
    """Deduplicated tile-fit sample jobs of one campaign.

    Draws and evaluations dedupe separately: a **draw** is one
    ``(dims, seed)`` sample stream (shared by every buffer size and stride
    that samples the same domain — e.g. fig8's six HWConfigs draw each probe
    layer once); an **evaluation job** is one
    ``(draw, stride, depthwise, buf)`` predicate pass over a draw.  Rows
    that share all of it (every flex level of a spec on a layer, a whole
    INFLEX sweep needing only the C_X reference) share one job.
    """

    def __init__(self, n: int):
        self.n = n
        self._draw_index: Dict[tuple, int] = {}
        self.draw_dims: List[np.ndarray] = []
        self.draw_seed: List[int] = []
        self._eval_index: Dict[tuple, int] = {}
        self.draw_id: List[int] = []
        self.stride: List[int] = []
        self.depthwise: List[bool] = []
        self.buf: List[float] = []

    def add(self, dims: np.ndarray, stride: int, depthwise: bool,
            buf: float, seed: int) -> int:
        dkey = (tuple(int(d) for d in dims), int(seed))
        if dkey not in self._draw_index:
            self._draw_index[dkey] = len(self.draw_dims)
            self.draw_dims.append(np.asarray(dims, np.int64))
            self.draw_seed.append(int(seed))
        di = self._draw_index[dkey]
        ekey = (di, int(stride), bool(depthwise), float(buf))
        if ekey not in self._eval_index:
            self._eval_index[ekey] = len(self.draw_id)
            self.draw_id.append(di)
            self.stride.append(int(stride))
            self.depthwise.append(bool(depthwise))
            self.buf.append(float(buf))
        return self._eval_index[ekey]

    def __len__(self) -> int:
        return len(self.draw_id)

    def evaluate(self, backend: str, device: torch.device, devices=None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Draw every sample stream once (host numpy) and evaluate both
        predicates of every job in chunked vectorized passes; returns
        (p_soft, p_hard) per evaluation job.

        Chunks flow through an in-flight queue (depth = pool size, 1
        without a pool): on the torch backend the next chunk's host draws
        overlap the dispatched chunk's device work, and with a device pool
        (``devices``, else ``REPRO_DEVICES``) chunk *i* runs on pool
        device ``i % D``.
        Values are unchanged — boolean means are per-row, so results are
        placement- and scheduling-independent."""
        j = len(self.draw_id)
        p_soft = np.zeros(j, np.float64)
        p_hard = np.zeros(j, np.float64)

        def store(sel, soft, hard):
            if backend == "torch":
                soft, hard = soft.cpu().numpy(), hard.cpu().numpy()
            p_soft[sel] = np.asarray(soft, np.float64)
            p_hard[sel] = np.asarray(hard, np.float64)
            return ()

        # only the torch backend queues work on a device; the numpy path is
        # synchronous and stays on the host
        pool = pool_of(devices, device) if backend == "torch" else None
        queue = InFlightQueue(depth=len(pool) if pool else 1, collect=store)
        draws_per_chunk = max(1, _CHUNK_SAMPLES // max(self.n, 1))
        for ci, dstart in enumerate(range(0, len(self.draw_dims),
                                          draws_per_chunk)):
            dstop = min(dstart + draws_per_chunk, len(self.draw_dims))
            t = np.empty((dstop - dstart, NUM_DIMS, self.n), np.float64)
            for d in range(dstart, dstop):
                _draw_tiles(self.draw_dims[d],
                            np.random.default_rng(self.draw_seed[d]),
                            self.n, out=t[d - dstart])
            sel = [i for i in range(j)
                   if dstart <= self.draw_id[i] < dstop]
            soft, hard = _eval_jobs(
                t,
                np.asarray([self.draw_id[i] - dstart for i in sel], np.int64),
                np.asarray([self.stride[i] for i in sel], np.float64),
                np.asarray([self.depthwise[i] for i in sel]),
                np.asarray([self.buf[i] for i in sel], np.float64),
                backend, pool.device_for(ci) if pool else device)
            queue.push(sel, soft, hard)
        queue.drain()
        return p_soft, p_hard


def _campaign(rows: Sequence[Tuple[FlexSpec, Optional[Layer], int,
                                   Optional[FlexSpec]]],
              n: int, ref_seed: int, device=None,
              devices=None) -> List["FlexionReport"]:
    """All requested flexion reports from one batched sample evaluation.

    ``rows``: (spec, layer-or-None, workload seed, reference-or-None).
    Row *i* is bit-identical to
    ``compute_flexion(spec, layer, n, seed=wseed, ref_seed=ref_seed)``.
    """
    from .flexion import FlexionReport   # wrappers live there; no top cycle

    if n <= 0:
        raise ValueError("mc_samples must be positive")
    device = resolve_device(device)
    backend = _backend(device)
    agn = _agnostic_dims()
    jobs = _Jobs(n)

    # -- collect the jobs each row needs ------------------------------------
    # reference fractions are read as an atomic (soft, hard) PAIR and held
    # locally: a row either has both values now or owns a job that will
    # produce both — no later re-read of the shared cache, so a concurrent
    # campaign (or LRU eviction between here and assembly) cannot expose a
    # half-populated reference
    ref_jobs: List[Optional[int]] = []
    ref_vals: List[Optional[Tuple[float, float]]] = []
    wl_jobs: List[Optional[int]] = []
    for spec, layer, wseed, _ in rows:
        hw = spec.hw
        pair = _REF_CACHE.get_pair((hw, False, n, ref_seed, backend),
                                   (hw, True, n, ref_seed, backend))
        ref_vals.append(pair)
        if pair is not None:
            ref_jobs.append(None)
        else:
            ref_jobs.append(jobs.add(agn, 1, False,
                                     float(hw.buffer_elems), ref_seed))
        if layer is not None and spec.tile.flex != INFLEX:
            wl_jobs.append(jobs.add(layer.as_array(), layer.stride,
                                    layer.depthwise,
                                    float(hw.buffer_elems), wseed))
        else:
            wl_jobs.append(None)

    p_soft, p_hard = (jobs.evaluate(backend, device, devices) if len(jobs)
                      else (np.zeros(0), np.zeros(0)))

    # -- memoize the C_X reference fractions --------------------------------
    # merge keeps the first stored pair (deterministic draws make racing
    # writers equal anyway) and hands back the canonical values
    for i, ((spec, _, _, _), rj) in enumerate(zip(rows, ref_jobs)):
        if rj is not None:
            ref_vals[i] = _REF_CACHE.merge_pair(
                (spec.hw, False, n, ref_seed, backend), float(p_soft[rj]),
                (spec.hw, True, n, ref_seed, backend), float(p_hard[rj]))

    # -- assemble reports ----------------------------------------------------
    out: List[FlexionReport] = []
    for (spec, layer, wseed, reference), wj, rv in zip(rows, wl_jobs,
                                                       ref_vals):
        ref = reference or _default_reference(spec)
        hf: Dict[str, float] = {}
        wf: Dict[str, float] = {}

        # O/P/S/R axes: exact (memoized) table counts
        n_ord = _order_count(spec.order)
        hf["O"] = n_ord / _order_count(ref.order)
        wf["O"] = n_ord / 720.0
        n_par = _pair_count(spec.parallel)
        hf["P"] = n_par / _pair_count(ref.parallel)
        wf["P"] = n_par / 30.0
        n_shape = _shape_count(spec.shape, spec.hw.num_pes)
        n_shape_ref = _shape_count(ref.shape, ref.hw.num_pes)
        hf["S"] = n_shape / n_shape_ref
        wf["S"] = n_shape / n_shape_ref  # workload does not constrain S
        n_repr = _repr_count(spec.representation,
                             8 * spec.hw.bytes_per_elem)
        n_repr_ref = _repr_count(ref.representation,
                                 8 * ref.hw.bytes_per_elem)
        hf["R"] = n_repr / n_repr_ref
        wf["R"] = n_repr / n_repr_ref  # workload does not constrain R

        # T axis: Monte-Carlo on paired samples + the memoized reference
        # (held locally since collection — see above)
        ref_soft, ref_hard = rv
        if spec.tile.flex == INFLEX:
            # A supports exactly 1 tile point.
            hf["T"] = 1.0 / max(ref_soft * _agnostic_volume(), 1.0)
            if layer is not None:
                wf["T"] = 1.0 / float(np.prod(np.asarray(layer.dims,
                                                         np.float64)))
            else:
                wf["T"] = hf["T"]
        else:
            hard = spec.tile.flex == PARTFLEX
            p_acc = ref_hard if hard else ref_soft
            hf["T"] = p_acc / max(ref_soft, 1e-12)
            if layer is not None:
                wf["T"] = float(p_hard[wj] if hard else p_soft[wj])
            else:
                wf["T"] = hf["T"]

        out.append(FlexionReport(
            per_axis_hf=hf, per_axis_wf=wf,
            hf=float(np.prod(list(hf.values()))),
            wf=float(np.prod(list(wf.values()))),
            mc_samples=n,
        ))
    return out


def flexion_campaign(rows, mc_samples: int = 200_000, seed: int = 0,
                     reference: Optional[FlexSpec] = None, device=None,
                     devices=None) -> List["FlexionReport"]:
    """Batched flexion of many (spec, layer) pairs in one vectorized pass.

    ``rows`` — ``(spec, layer)`` pairs (``layer`` may be ``None`` for the
    workload-agnostic report) or ``(spec, layer, wseed)`` triples with an
    explicit per-row workload seed.  Two-tuples get ``wseed = seed + i``
    (the ``model_flexion`` per-layer convention); the C_X reference streams
    always use ``seed``.  Row *i* is bit-identical to
    ``compute_flexion(spec, layer, mc_samples, seed=wseed, ref_seed=seed)``.
    ``devices`` is the device pool of the torch backend's chunks (a
    ``GAConfig.devices`` spec, else ``REPRO_DEVICES``).
    """
    norm = []
    for i, row in enumerate(rows):
        if len(row) == 2:
            spec, layer = row
            wseed = seed + i
        else:
            spec, layer, wseed = row
        norm.append((spec, layer, int(wseed), reference))
    return _campaign(norm, int(mc_samples), int(seed), device, devices)


def model_flexion_campaign(requests, mc_samples: int = 50_000,
                           seed: int = 0, device=None, devices=None
                           ) -> List["FlexionReport"]:
    """Model-averaged flexion of many (spec, layers) requests at once.

    Each request's W-F is the mean over its layers (per-layer workload seeds
    ``seed + i``, *i* the layer index within the request); H-F comes from
    the shared reference cache, so it is identical for every layer — and
    for every request sharing an HWConfig.  Request *j* is bit-identical to
    ``model_flexion(spec_j, layers_j, mc_samples, seed)``.
    """
    from .flexion import FlexionReport

    rows = []
    spans = []
    for spec, layers in requests:
        layers = list(layers)
        if not layers:
            raise ValueError("model has no layers")
        spans.append((len(rows), len(layers)))
        rows.extend((spec, layer, seed + i, None)
                    for i, layer in enumerate(layers))
    reports = _campaign(rows, int(mc_samples), int(seed), device, devices)
    out = []
    for start, count in spans:
        sub = reports[start:start + count]
        wf = float(np.mean([r.wf for r in sub]))
        out.append(FlexionReport(per_axis_hf=sub[0].per_axis_hf,
                                 per_axis_wf={"avg": wf}, hf=sub[0].hf,
                                 wf=wf, mc_samples=int(mc_samples)))
    return out
