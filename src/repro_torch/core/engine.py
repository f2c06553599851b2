"""Batched multi-layer MSE engine: a whole model's GA as batched tensor ops
on one device.

The paper's DSE loop (Sec 2.4 / Fig 6) runs a full map-space exploration per
benchmark layer at *every* DSE step.  The serial mapper evaluates one
population per layer per generation and breeds on the host.  This engine
stacks the GA state of all rows (a row = one (layer, spec) pair) into an
``(L, P, 10)`` genome tensor and keeps decode, cost evaluation, selection,
crossover and mutation on the device: one Python loop over generations of
batched torch ops, with nothing read back to the host until the loop ends.

Rows are processed in fixed-size chunks (``ROW_BUCKET``), O/P/S/R index
tables are padded to the class-wide C_X maxima and indexed modulo their
*true* lengths, the table axis is padded to ``TABLE_BUCKET`` and the draw
arrays to a ``GEN_BUCKET`` multiple of generations — the chunk layout of the
JAX engine, kept so both packages assemble identical host arrays
(``_prepare_chunk`` is unchanged).

Randomness is drawn host-side (``ga_ops.draw_run``, one numpy Generator per
row seeded with the serial mapper's convention) and uploaded once per chunk.
Chunks can be placed over a device pool and pipelined (``GAConfig.devices``,
``GAConfig.pipeline``; see :func:`run_batched_ga`).

Parity with ``mapper.search_model(engine="serial")`` is by construction:
both engines consume the same per-row draw streams and apply the same
``ga_ops`` operator arithmetic (float32 mutate steps, stable argsort,
strict-improve best tracking).
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..dist.pool import InFlightQueue
from . import device_pool, ga_ops
from .cost_model import CostResult, evaluate_mapping_impl
from .ga_ops import GENOME_LEN, GenDraws
from .mapspace import mapspace_for, padded_tables
from .spec import FlexSpec, HWConfig
from .workloads import Layer

ROW_BUCKET = 64     # rows per chunk; larger row sets run in chunks
GEN_BUCKET = 16     # draw arrays padded to a multiple of this
TABLE_BUCKET = 8    # distinct spec table-sets per chunk, padded


def _bucket(n: int, base: int) -> int:
    b = base
    while b < n:
        b *= 2
    return b


class RowResult(NamedTuple):
    """Host-side per-row outcome of a batched GA run."""

    best_genome: np.ndarray    # (10,) i32
    best_obj: float
    history: List[float]       # best objective per generation
    runtime: float
    energy: float
    edp: float
    util: float
    dram_elems: float
    feasible: bool


def _ga_program(dims, stride, depthwise, tile_lo, tile_hi, hard_partition,
                table_id, orders, pairs, shapes, reprs, lens, pop0, draws,
                n_gens: int, hw: HWConfig, n_elite: int, objective: str,
                with_repr: bool = False):
    """The whole GA for all rows of a chunk, on the tensors' device.

    Shapes: dims (L,6) stride (L,) depthwise (L,) tile_lo/hi (L,6)
    hard_partition (L,) table_id (L,) orders (T,720,6) pairs (T,30,2)
    shapes (T,S,2) reprs (T,R_PAD) lens (T,4) pop0 (L,P,10) draws leaves
    (Gp,L,Pc,...).

    ``with_repr`` selects the cost-model program: False evaluates without
    width scaling (native-pinned rows, the reference's parity rule);
    True threads each mapping's decoded bit-width into the cost model.
    """
    xp = ga_ops.TORCH
    n_rows = pop0.shape[0]
    tid = table_id.long()[:, None]                   # (L, 1)
    row_lens = lens[tid[:, 0]]                       # (L, 4)
    lo_b = tile_lo[:, None, :]
    hi_b = tile_hi[:, None, :]
    lens_b = row_lens[:, None, :]
    dims_b, stride_b = dims[:, None, :], stride[:, None]
    dw_b, hp_b = depthwise[:, None], hard_partition[:, None]

    def evaluate(pop) -> CostResult:
        def index(gene, axis):
            return torch.remainder(pop[..., gene],
                                   row_lens[:, None, axis]).long()

        bits = reprs[tid, index(9, 3)] if with_repr else None
        return evaluate_mapping_impl(
            dims_b, stride_b, dw_b, pop[..., 0:6], orders[tid, index(6, 0)],
            pairs[tid, index(7, 1)], shapes[tid, index(8, 2)], hw, hp_b,
            bits)

    dev = pop0.device
    zeros = torch.zeros(n_rows, dtype=torch.float32, device=dev)
    pop = pop0
    best_obj = torch.full((n_rows,), float("inf"), device=dev)
    best_g = pop0[:, 0, :].clone()
    best = CostResult(runtime=zeros, energy=zeros,
                      feasible=torch.zeros(n_rows, dtype=torch.bool,
                                           device=dev),
                      util=zeros, dram_elems=zeros, l2_elems=zeros,
                      edp=zeros)
    hist = torch.full((draws.step.shape[0], n_rows), float("inf"),
                      device=dev)
    for i in range(n_gens):
        d = ga_ops.gen_slice(draws, i)
        res = evaluate(pop)
        obj = getattr(res, objective)                          # (L, P)
        order_idx = torch.argsort(obj, dim=1, stable=True)
        gen_best = order_idx[:, :1]
        gen_obj = obj.gather(1, gen_best)[:, 0]
        improved = gen_obj < best_obj
        best_obj = torch.where(improved, gen_obj, best_obj)
        gen_g = xp.take_along_axis(pop, gen_best[:, :, None], 1)[:, 0]
        best_g = torch.where(improved[:, None], gen_g, best_g)
        # carry the winner's full cost breakdown
        best = CostResult(*(
            torch.where(improved, f.gather(1, gen_best)[:, 0], bf)
            for f, bf in zip(res, best)))
        hist[i] = best_obj

        elites = xp.take_along_axis(pop, order_idx[:, :n_elite, None], 1)
        parent_idx = xp.take_along_axis(order_idx, d.ranks, 1)
        parents = xp.take_along_axis(pop, parent_idx[..., None], 1)
        children = ga_ops.apply_crossover(parents, d, xp)
        children = ga_ops.clip_genomes(children, lo_b, hi_b, lens_b, xp)
        children = ga_ops.apply_mutation(children, d, lo_b, hi_b, lens_b,
                                         xp)
        pop = torch.cat([elites, children], dim=1)
    return best_g, best_obj, hist, best


@dataclasses.dataclass(frozen=True)
class EngineRow:
    """One (layer, spec, seed) search request; seeds follow the serial
    mapper's convention (``cfg.seed + 1000 * first_occurrence_index``)."""

    layer: Layer
    spec: FlexSpec
    seed: int


class ChunkInputs(NamedTuple):
    """Host-side arrays of one padded engine chunk, ready to dispatch."""

    dims: np.ndarray
    stride: np.ndarray
    depthwise: np.ndarray
    tile_lo: np.ndarray
    tile_hi: np.ndarray
    hard_partition: np.ndarray
    table_id: np.ndarray
    orders: np.ndarray
    pairs: np.ndarray
    shapes: np.ndarray
    reprs: np.ndarray
    lens: np.ndarray
    pop0: np.ndarray
    draws: GenDraws
    gens: int


def ga_params_key(cfg) -> tuple:
    """The GAConfig fields a row's search RESULT depends on, as a hashable
    key.  Left out on purpose: ``engine`` (serial and batched rows are
    bit-identical), ``pipeline`` and ``devices`` (scheduling and placement
    only) and ``seed`` (keyed per row: :func:`row_cache_key` folds
    ``EngineRow.seed``).  Two configs with equal keys produce bit-identical
    rows."""
    return ("ga-v1", cfg.population, cfg.generations, cfg.elite_frac,
            cfg.mutation_rate, cfg.crossover_rate, cfg.tile_divisor_bias,
            cfg.objective)


def row_cache_key(row: EngineRow, cfg) -> tuple:
    """Canonical persistent-cache key of one engine row: GA params + spec +
    the spec-relevant layer fields + the row seed.  Layer *names* are
    excluded, so equal shapes from different models share one result."""
    layer = row.layer
    return ("mapper-row", ga_params_key(cfg), row.spec,
            tuple(int(d) for d in layer.dims), int(layer.stride),
            bool(layer.depthwise), int(row.seed))


def run_batched_ga(rows: Sequence[EngineRow], cfg, row_cache=None,
                   device=None) -> List[RowResult]:
    """Search all rows batched on ``device`` (``None``: the CUDA card);
    returns per-row results in order (``[]`` for an empty row set).  All
    rows must share an HWConfig.

    With ``row_cache`` (a :class:`~repro_torch.core.result_cache.
    ResultCache`), rows are answered from the cache when a bit-identical
    search — same :func:`row_cache_key` — was already run, and rows that
    share a key within this call dispatch once.  Cached results equal a
    fresh dispatch, so the returned list is unchanged by any cache state.

    With a device pool (``cfg.devices``, else ``REPRO_DEVICES``; see
    :mod:`repro_torch.core.device_pool`) chunk ``i`` runs on pool device
    ``i % len(pool)`` instead of ``device``.  Chunks are independent, so
    placement alone never changes a result.

    With ``cfg.pipeline`` the chunk loop is software-pipelined through an
    :class:`~repro_torch.dist.pool.InFlightQueue`: chunk ``i`` is
    dispatched (its GA ops are queued on the device without the host
    waiting) and while the device crunches it, the host assembles the
    next chunks' draw streams, keeping up to one chunk in flight *per pool
    device* before blocking on the oldest.  Scheduling only: results stay
    bit-identical to the unpipelined loop.  If preparing or dispatching a
    later chunk raises, the already-dispatched chunks are still collected
    (never abandoned mid-device) and the error is re-raised with the
    failing chunk's context.
    """
    device = resolve_device(device)
    if not rows:
        return []
    if row_cache is not None:
        keys = [row_cache_key(r, cfg) for r in rows]
        cached = [row_cache.get(k) for k in keys]
        todo_rows: List[EngineRow] = []
        todo_keys: List[tuple] = []
        first_pos: dict = {}
        for r, k, c in zip(rows, keys, cached):
            if c is None and k not in first_pos:
                first_pos[k] = len(todo_rows)
                todo_rows.append(r)
                todo_keys.append(k)
        fresh = run_batched_ga(todo_rows, cfg, device=device)
        # merge keeps the first stored result; nothing is cached if the
        # dispatch raised above, so a retry starts clean
        stored = {k: row_cache.merge(k, res)
                  for k, res in zip(todo_keys, fresh)}
        return [c if c is not None else stored[k]
                for k, c in zip(keys, cached)]
    hw = rows[0].spec.hw
    if any(r.spec.hw != hw for r in rows):
        raise ValueError("batched rows must share an HWConfig")
    pool = device_pool.pool_for(cfg, device)
    chunks = [rows[start:start + ROW_BUCKET]
              for start in range(0, len(rows), ROW_BUCKET)]

    def device_for(idx: int) -> torch.device:
        return pool.device_for(idx) if pool else device

    out: List[RowResult] = []
    if not getattr(cfg, "pipeline", False):
        for idx, chunk in enumerate(chunks):
            inputs = _prepare_chunk(chunk, cfg, hw)
            out.extend(_collect_chunk(
                len(chunk), inputs.gens,
                _dispatch_chunk(inputs, cfg, hw, device_for(idx))))
        return out

    n_chunks = len(chunks)

    def collect_with_context(idx, n_rows, gens, outputs):
        try:
            return _collect_chunk(n_rows, gens, outputs)
        except Exception as e:
            raise RuntimeError(
                f"engine chunk {idx}/{n_chunks} failed during "
                f"collection") from e

    queue = InFlightQueue(depth=len(pool) if pool else 1,
                          collect=collect_with_context)
    try:
        for idx, chunk in enumerate(chunks):
            try:
                inputs = _prepare_chunk(chunk, cfg, hw)
                outputs = _dispatch_chunk(inputs, cfg, hw, device_for(idx))
            except Exception as e:
                raise RuntimeError(
                    f"engine chunk {idx}/{n_chunks} (rows "
                    f"{idx * ROW_BUCKET}.."
                    f"{idx * ROW_BUCKET + len(chunk) - 1}"
                    f") failed during prepare/dispatch") from e
            out.extend(queue.push(idx, len(chunk), inputs.gens, outputs))
        out.extend(queue.drain())
    except Exception:
        # never abandon dispatched device work: block on every remaining
        # in-flight chunk (each drain attempt consumes at least one entry,
        # so this terminates) before propagating the chunk-contextualized
        # error
        while len(queue):
            try:
                queue.drain()
            except Exception:  # noqa: BLE001 - the original error wins
                pass
        raise
    return out


def _prepare_chunk(rows: Sequence[EngineRow], cfg, hw: HWConfig
                   ) -> ChunkInputs:
    """Assemble one chunk's padded host arrays (tables, populations, draw
    streams).  Pure host work, identical to the JAX engine's — under
    ``cfg.pipeline`` it overlaps the previous chunk's device work."""
    population = cfg.population
    n_children = population - ga_ops.n_elite(cfg)
    gens = cfg.generations
    gens_pad = _bucket(max(gens, 1), GEN_BUCKET)
    n_pad = ROW_BUCKET

    # -- distinct padded table sets + per-row table id ----------------------
    spec_ids = {}
    tables = []
    table_id = np.zeros(n_pad, np.int32)
    for i, row in enumerate(rows):
        if row.spec not in spec_ids:
            spec_ids[row.spec] = len(tables)
            tables.append(padded_tables(row.spec))
        table_id[i] = spec_ids[row.spec]
    t_pad = _bucket(len(tables), TABLE_BUCKET)
    orders = np.zeros((t_pad,) + tables[0].orders.shape, np.int32)
    pairs = np.zeros((t_pad,) + tables[0].pairs.shape, np.int32)
    shapes = np.zeros((t_pad,) + tables[0].shapes.shape, np.int32)
    # inert table slots decode to the native width (bits index 0 via lens=1)
    reprs = np.full((t_pad,) + tables[0].reprs.shape,
                    8 * hw.bytes_per_elem, np.int32)
    lens = np.ones((t_pad, 4), np.int32)
    for ti, t in enumerate(tables):
        orders[ti], pairs[ti], shapes[ti], reprs[ti], lens[ti] = (
            t.orders, t.pairs, t.shapes, t.reprs, t.lens)

    # -- per-row state + draws, inert-padded to the buckets -----------------
    dims = np.ones((n_pad, 6), np.int32)
    stride = np.ones(n_pad, np.int32)
    depthwise = np.zeros(n_pad, np.bool_)
    tile_lo = np.ones((n_pad, 6), np.int32)
    tile_hi = np.ones((n_pad, 6), np.int32)
    hard_partition = np.zeros(n_pad, np.bool_)
    pop0 = np.ones((n_pad, population, GENOME_LEN), np.int32)
    draw_stack = ga_ops.empty_draw_stack(gens_pad, n_pad, n_children)
    for i, row in enumerate(rows):
        space = mapspace_for(row.layer, row.spec)
        rng = np.random.default_rng(row.seed)
        pop0[i] = ga_ops.initial_population(rng, space, cfg)
        row_draws = ga_ops.draw_run(rng, space, cfg, gens, n_children)
        for field, stacked in zip(row_draws, draw_stack):
            stacked[:gens, i] = field
        dims[i] = space.dims
        stride[i] = row.layer.stride
        depthwise[i] = row.layer.depthwise
        tile_lo[i] = space.tile_lo
        tile_hi[i] = space.tile_hi
        hard_partition[i] = space.hard_partition

    return ChunkInputs(dims=dims, stride=stride, depthwise=depthwise,
                       tile_lo=tile_lo, tile_hi=tile_hi,
                       hard_partition=hard_partition, table_id=table_id,
                       orders=orders, pairs=pairs, shapes=shapes,
                       reprs=reprs, lens=lens, pop0=pop0, draws=draw_stack,
                       gens=gens)


def scales_width(reprs, n_reprs: int, native: int) -> bool:
    """Whether an R table takes the width-scaled cost graph: open, or
    pinned off the native width.  The scaled and unscaled graphs round
    energies differently in the last bit, so rows that must match a solo
    campaign never share a chunk across this line."""
    n = int(n_reprs)
    return n > 1 or bool((reprs[:max(n, 1)] != native).any())


def spec_scales_width(spec: FlexSpec) -> bool:
    """:func:`scales_width` for one spec's R table."""
    t = padded_tables(spec)
    return scales_width(t.reprs, t.lens[3], 8 * spec.hw.bytes_per_elem)


def _dispatch_chunk(c: ChunkInputs, cfg, hw: HWConfig, device):
    """Upload the chunk and queue its GA on ``device``; returns device
    tensors without waiting for them (the GA's generation loop never makes
    the host wait, so on a CUDA device the caller runs on while the device
    works)."""
    # native-pinned chunks run without width scaling (reference parity);
    # only a chunk with an open or off-native R table pays the scaled graph
    native = 8 * hw.bytes_per_elem
    with_repr = any(scales_width(r, l, native)
                    for r, l in zip(c.reprs, c.lens[:, 3]))
    # pageable copies: on the launch-bound GA the device has drained by the
    # time they run, and staging through pinned memory measured no faster
    args = [torch.as_tensor(a, device=device) for a in (
        c.dims, c.stride, c.depthwise, c.tile_lo, c.tile_hi,
        c.hard_partition, c.table_id, c.orders, c.pairs, c.shapes, c.reprs,
        c.lens, c.pop0, *c.draws)]
    draws = GenDraws(*args[13:])
    return _ga_program(
        *args[:13], draws, c.gens,
        hw=hw, n_elite=ga_ops.n_elite(cfg), objective=cfg.objective,
        with_repr=with_repr)


def _collect_chunk(n_rows: int, gens: int, outputs) -> List[RowResult]:
    """Materialize a dispatched chunk (waits on the device) and unpack the
    live rows."""
    best_g, best_obj, hist, best = outputs
    best_g = best_g.cpu().numpy()
    best_obj = best_obj.cpu().numpy()
    hist = hist.cpu().numpy()
    best = CostResult(*(f.cpu().numpy() for f in best))

    out = []
    for i in range(n_rows):
        out.append(RowResult(
            best_genome=best_g[i],
            best_obj=float(best_obj[i]),
            history=[float(v) for v in hist[:gens, i]],
            runtime=float(best.runtime[i]),
            energy=float(best.energy[i]),
            edp=float(best.edp[i]),
            util=float(best.util[i]),
            dram_elems=float(best.dram_elems[i]),
            feasible=bool(best.feasible[i]),
        ))
    return out


def warmup_engine(cfg, hw: Optional[HWConfig] = None, device=None) -> None:
    """Run one tiny chunk outside any timed region (brings up the device
    context and the caching allocators before a benchmark loop).  With a
    device pool (``cfg.devices`` / ``REPRO_DEVICES``) the chunk runs on
    EVERY pool device, so each is warm before timed chunks round-robin
    over them."""
    from .spec import make_variant
    hw = hw or HWConfig()
    device = resolve_device(device)
    row = EngineRow(Layer("warmup", (4, 4, 4, 4, 1, 1)),
                    make_variant("1111", hw=hw), seed=0)
    pool = device_pool.pool_for(cfg, device)
    inputs = _prepare_chunk([row], cfg, hw)
    for dev in (pool.devices if pool else (device,)):
        _collect_chunk(1, inputs.gens,
                       _dispatch_chunk(inputs, cfg, hw, dev))
