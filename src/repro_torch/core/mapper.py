"""GAMMA-style genetic-algorithm mapper with flexibility-constrained operators
(paper Sec 5).

The native GAMMA mapper supports InFlex-0000 or FullFlex-1111; the paper's
extension (reproduced here) constrains the search inside any of the 16
classes and further inside PartFlex subsets:

  * inflexible axes are *pinned* (genes never mutate off the fixed value),
  * PartFlex axes index into restricted tables (orders / pairs / shapes) or
    apply the hard-partition legality (tiles),
  * FullFlex axes roam the full constrained space C_X.

Two interchangeable MSE engines sit behind ``GAConfig.engine``:

  * ``"batched"`` (default): the whole model's GA — every unique layer's
    population stacked into an (L, P, 10) tensor — runs as batched tensor
    ops on the device (see repro_torch.core.engine).
  * ``"serial"``: the classic per-layer Python loop, one cost-model pass on
    the device per layer per generation, breeding on the host.

Both engines consume identical random streams and operator arithmetic
(repro_torch.core.ga_ops), so they return bit-identical results for the
same ``GAConfig``.  Every entry point takes ``device`` (``None``: the CUDA
card).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..dist.pool import InFlightQueue, parse_device_spec
from . import device_pool, ga_ops
from .cost_model import (CostResult, evaluate_mapping_impl,
                         evaluate_population, evaluate_rows)
from .engine import ROW_BUCKET, EngineRow, _bucket, run_batched_ga
from .mapspace import Mapping, MapSpace, mapspace_for
from .spec import FlexSpec, HWConfig
from .workloads import NUM_DIMS, Layer, layers_as_array

ENGINES = ("batched", "serial")


def _normalize_devices(devices):
    """Canonicalize ``GAConfig.devices`` to a hashable form (int count,
    index tuple, or stripped string) and validate it at construction,
    through the one grammar in ``repro_torch.dist.pool.parse_device_spec``
    — so a bad spec fails here, not deep inside a chunk dispatch."""
    if isinstance(devices, np.integer):
        devices = int(devices)
    if isinstance(devices, str):
        devices = devices.strip()
        if not devices:
            return None
    elif not isinstance(devices, int):      # bools flow through to parse
        try:
            devices = tuple(int(i) for i in devices)
        except TypeError as e:
            raise ValueError(f"invalid devices spec {devices!r}") from e
    parse_device_spec(devices)              # raises ValueError on garbage
    return devices


@dataclasses.dataclass(frozen=True)
class GAConfig:
    population: int = 100
    generations: int = 100      # paper: 100x100 = 10K samples
    elite_frac: float = 0.10
    mutation_rate: float = 0.5  # paper: 0.5
    crossover_rate: float = 0.5
    tile_divisor_bias: float = 0.3  # GAMMA-style: snap tiles to divisors
    seed: int = 0
    objective: str = "runtime"  # runtime | energy | edp
    engine: str = "batched"     # batched | serial (identical results)
    pipeline: bool = False      # overlap host draw prep with device compute
    devices: Optional[object] = None
                                # device pool for engine chunks: a count,
                                # "all", or tuple of device indices
                                # (repro_torch.dist.pool)

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; "
                             f"expected one of {ENGINES}")
        # Degenerate GA shapes are rejected HERE so both engines fail
        # identically, at construction, with an actionable message.
        if self.population < 2:
            raise ValueError(
                f"population must be >= 2 (elites plus at least one child), "
                f"got {self.population}")
        if self.generations < 1:
            raise ValueError(
                f"generations must be >= 1, got {self.generations}")
        if not 0.0 <= self.elite_frac < 1.0:
            raise ValueError(
                f"elite_frac must be in [0, 1) so n_children >= 1, "
                f"got {self.elite_frac}")
        for field in ("mutation_rate", "crossover_rate"):
            v = getattr(self, field)
            if not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"{field} must be in [0, 1], got {v}")
        if self.objective not in ("runtime", "energy", "edp"):
            raise ValueError(f"unknown objective {self.objective!r}")
        if self.devices is not None:
            object.__setattr__(self, "devices",
                               _normalize_devices(self.devices))


@dataclasses.dataclass
class MapperResult:
    mapping: Mapping
    runtime: float
    energy: float
    edp: float
    util: float
    dram_elems: float
    feasible: bool
    history: List[float]        # best objective per generation

    def objective(self, name: str) -> float:
        return {"runtime": self.runtime, "energy": self.energy,
                "edp": self.edp}[name]


class _Operators:
    """Constraint-respecting GA operators over genome matrices (N, 10):
    host-side wrappers over the shared draw/apply functions in ``ga_ops``
    (the fixed-config search breeds with them, one Generator per model)."""

    def __init__(self, space: MapSpace, cfg: GAConfig,
                 rng: np.random.Generator):
        self.space = space
        self.cfg = cfg
        self.rng = rng

    def mutate(self, g: np.ndarray) -> np.ndarray:
        d = ga_ops.single_generation_draws(self.rng, self.space, self.cfg,
                                           len(g))
        return ga_ops.apply_mutation(np.asarray(g), d, self.space.tile_lo,
                                     self.space.tile_hi,
                                     self.space.table_lens(), np)

    def crossover(self, parents: np.ndarray) -> np.ndarray:
        d = ga_ops.single_generation_draws(self.rng, self.space, self.cfg,
                                           len(parents))
        return self.space.clip(
            ga_ops.apply_crossover(np.asarray(parents), d, np))


def _layer_tensors(layer: Layer, device):
    return (torch.tensor(layer.dims, device=device),
            torch.tensor(layer.stride, device=device),
            torch.tensor(layer.depthwise, device=device))


def _search_serial(layer: Layer, spec: FlexSpec, cfg: GAConfig,
                   device=None) -> MapperResult:
    """Per-layer GA: one cost-model pass on ``device`` per generation,
    selection and breeding on the host (the reference engine the batched
    one is held to)."""
    device = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    space = mapspace_for(layer, spec)
    pop = ga_ops.initial_population(rng, space, cfg)
    n_elite = ga_ops.n_elite(cfg)
    draws = ga_ops.draw_run(rng, space, cfg, cfg.generations,
                            cfg.population - n_elite)
    lens = space.table_lens()

    dims, stride, dw = _layer_tensors(layer, device)
    # native-pinned R runs without width scaling (reference parity)
    r_live = (len(space.repr_table) > 1
              or int(space.repr_table[0]) != 8 * spec.hw.bytes_per_elem)

    def up(a):
        return torch.as_tensor(a, device=device)

    best_hist: List[float] = []
    best_g: Optional[np.ndarray] = None
    best_obj = np.inf
    best_idx_res: Optional[Tuple[CostResult, int]] = None

    for gen in range(cfg.generations):
        tiles, orders, pairs, shapes, reprs = space.decode_batch(pop)
        res = evaluate_population(
            dims, stride, dw, up(tiles), up(orders), up(pairs), up(shapes),
            spec.hw, space.hard_partition, up(reprs) if r_live else None)
        obj = getattr(res, cfg.objective).cpu().numpy()
        order_idx = np.argsort(obj, kind="stable")
        if obj[order_idx[0]] < best_obj:
            best_obj = float(obj[order_idx[0]])
            best_g = pop[order_idx[0]].copy()
            best_idx_res = (res, int(order_idx[0]))
        best_hist.append(best_obj)

        pop = ga_ops.next_population(pop, order_idx,
                                     ga_ops.gen_slice(draws, gen),
                                     space.tile_lo, space.tile_hi, lens,
                                     n_elite, np)

    assert best_g is not None and best_idx_res is not None
    res, i = best_idx_res
    return MapperResult(
        mapping=space.decode(best_g),
        runtime=float(res.runtime[i]), energy=float(res.energy[i]),
        edp=float(res.edp[i]), util=float(res.util[i]),
        dram_elems=float(res.dram_elems[i]),
        feasible=bool(res.feasible[i]), history=best_hist,
    )


def _row_to_result(layer: Layer, spec: FlexSpec, row) -> MapperResult:
    space = mapspace_for(layer, spec)
    return MapperResult(
        mapping=space.decode(row.best_genome),
        runtime=row.runtime, energy=row.energy, edp=row.edp,
        util=row.util, dram_elems=row.dram_elems, feasible=row.feasible,
        history=row.history,
    )


def search(layer: Layer, spec: FlexSpec, cfg: Optional[GAConfig] = None,
           device=None) -> MapperResult:
    """MSE for one layer on one accelerator (paper Fig 6 inner loop)."""
    cfg = cfg or GAConfig()
    if cfg.engine == "serial":
        return _search_serial(layer, spec, cfg, device)
    row = run_batched_ga([EngineRow(layer, spec, cfg.seed)], cfg,
                         device=device)[0]
    return _row_to_result(layer, spec, row)


@dataclasses.dataclass
class ModelResult:
    per_layer: List[MapperResult]
    runtime: float
    energy: float
    edp: float

    @property
    def feasible(self) -> bool:
        return all(r.feasible for r in self.per_layer)


def _dedup_key(layer: Layer) -> tuple:
    """The spec-relevant layer fields — exactly what the cost model reads.
    Layer *names* (and any future metadata) must never enter this key."""
    return (layer.dims, layer.stride, layer.depthwise)


def plan_model_rows(layers: Sequence[Layer], dedup: bool = True
                    ) -> Tuple[List[int], Dict[tuple, int]]:
    """One model's engine-row plan: ``row_index`` lists the first-occurrence
    layer indices that become rows, ``seen`` maps each dedup key to its row
    position (per-layer GA seeds are ``cfg.seed + 1000 *
    first_occurrence_index``)."""
    row_index: List[int] = []
    seen: Dict[tuple, int] = {}
    for i, layer in enumerate(layers):
        key = _dedup_key(layer)
        if dedup and key in seen:
            continue
        seen[key] = len(row_index)
        row_index.append(i)
    return row_index, seen


def request_rows(layers: Sequence[Layer], spec: FlexSpec, cfg: "GAConfig",
                 row_index: Sequence[int]) -> List[EngineRow]:
    """The planned rows as :class:`EngineRow`\\ s with the campaign seed
    convention (``cfg.seed + 1000 * first_occurrence_index``)."""
    return [EngineRow(layers[i], spec, cfg.seed + 1000 * i)
            for i in row_index]


def assemble_model_result(layers: Sequence[Layer], spec: FlexSpec,
                          row_index: Sequence[int], seen: Dict[tuple, int],
                          row_results: Sequence, dedup: bool = True
                          ) -> ModelResult:
    """Fold one request's engine-row results back into a :class:`ModelResult`
    (the inverse of :func:`plan_model_rows`); deduped layers share their
    first occurrence's MapperResult object."""
    per_row = [_row_to_result(layers[i], spec, r)
               for i, r in zip(row_index, row_results)]
    if dedup:
        results = [per_row[seen[_dedup_key(l)]] for l in layers]
    else:
        results = list(per_row)
    return _model_result(results)


def _model_result(results: Sequence[MapperResult]) -> ModelResult:
    runtime = float(sum(r.runtime for r in results))
    energy = float(sum(r.energy for r in results))
    return ModelResult(per_layer=list(results), runtime=runtime,
                       energy=energy, edp=runtime * energy)


def search_model(layers: Sequence[Layer], spec: FlexSpec,
                 cfg: Optional[GAConfig] = None, dedup: bool = True,
                 device=None) -> ModelResult:
    """Per-layer MSE (flexible accelerators re-map every layer; paper Sec 3.1
    scope: layers run sequentially).

    Identical layer *shapes* share one search (:func:`_dedup_key`; names
    are excluded).  Per-layer GA seeds derive from the *first occurrence*
    index (``seed + 1000*i``), so dedup changes no result.  ``cfg.engine``
    selects the batched engine (default) or the serial per-layer loop;
    both return identical results.
    """
    cfg = cfg or GAConfig()
    if cfg.engine == "batched":
        return search_model_batched(layers, spec, cfg, dedup=dedup,
                                    device=device)
    results: List[Optional[MapperResult]] = [None] * len(layers)
    seen: Dict[tuple, int] = {}
    for i, layer in enumerate(layers):
        key = _dedup_key(layer)
        if dedup and key in seen:
            results[i] = results[seen[key]]
            continue
        lcfg = dataclasses.replace(cfg, seed=cfg.seed + 1000 * i)
        results[i] = search(layer, spec, lcfg, device)
        seen[key] = i
    return _model_result(results)


def search_model_batched(layers: Sequence[Layer], spec: FlexSpec,
                         cfg: Optional[GAConfig] = None, dedup: bool = True,
                         row_cache=None, device=None) -> ModelResult:
    """Batched MSE: all unique layers' GAs run as one (L, P, 10) genome
    tensor on the device (see repro_torch.core.engine).  Same dedup and
    per-layer seeds as the serial loop, hence bit-identical results.
    ``row_cache`` answers already-searched rows without changing any
    result."""
    cfg = cfg or GAConfig()
    row_index, seen = plan_model_rows(layers, dedup)
    rows = request_rows(layers, spec, cfg, row_index)
    row_results = run_batched_ga(rows, cfg, row_cache=row_cache,
                                 device=device)
    return assemble_model_result(layers, spec, row_index, seen, row_results,
                                 dedup)


def raw_tile_feasibility(tiles: torch.Tensor,
                         buffer_elems: float) -> torch.Tensor:
    """Hard-coded loop bounds must fit the buffer for ANY workload (tiles
    only ever clip DOWN on a layer).  tiles: (..., 6) raw genome tile genes;
    returns a (...) bool mask."""
    t = tiles.to(torch.float32)
    in_vol = t[..., 1] * (t[..., 2] - 1 + t[..., 4]) * \
        (t[..., 3] - 1 + t[..., 5])
    w_vol = t[..., 0] * t[..., 1] * t[..., 4] * t[..., 5]
    o_vol = t[..., 0] * t[..., 2] * t[..., 3]
    return (in_vol + w_vol + o_vol) <= buffer_elems


def search_campaign(requests: Sequence[Tuple[Sequence[Layer], FlexSpec]],
                    cfg: Optional[GAConfig] = None, dedup: bool = True,
                    row_cache=None, device=None) -> List[ModelResult]:
    """Campaign MSE: many whole-model searches — arbitrary (layers, spec)
    pairs sharing an HWConfig — as ONE engine row set.

    The engine packs all (model, spec, unique-layer) rows into full
    ``ROW_BUCKET`` chunks instead of padding each model/spec call
    separately.  Per-request results are bit-identical to per-request
    ``search_model_batched`` calls: rows keep the same per-layer dedup and
    seed convention (``cfg.seed + 1000 * first_occurrence_index``), and
    rows are independent, so packing them differently changes nothing.  An
    empty campaign returns ``[]``; ``row_cache`` answers repeat rows without
    dispatch, results unchanged."""
    cfg = cfg or GAConfig()
    requests = [(list(layers), spec) for layers, spec in requests]
    all_rows: List[EngineRow] = []
    meta: List[Tuple[List[int], Dict[tuple, int]]] = []
    for layers, spec in requests:
        row_index, seen = plan_model_rows(layers, dedup)
        meta.append((row_index, seen))
        all_rows.extend(request_rows(layers, spec, cfg, row_index))
    row_results = run_batched_ga(all_rows, cfg, row_cache=row_cache,
                                 device=device)
    out: List[ModelResult] = []
    pos = 0
    for (layers, spec), (row_index, seen) in zip(requests, meta):
        chunk = row_results[pos:pos + len(row_index)]
        pos += len(row_index)
        out.append(assemble_model_result(layers, spec, row_index, seen,
                                         chunk, dedup))
    return out


def search_specs_batched(layers: Sequence[Layer], specs: Sequence[FlexSpec],
                         cfg: Optional[GAConfig] = None, dedup: bool = True,
                         device=None) -> List[ModelResult]:
    """MSE for several candidate accelerators *sharing an HWConfig* as one
    engine row set ((spec, unique-layer) rows).  Each spec's ModelResult is
    bit-identical to its own ``search_model_batched`` call.  One-model case
    of :func:`search_campaign`."""
    return search_campaign([(layers, spec) for spec in specs], cfg,
                           dedup=dedup, device=device)


def _inert_mapping_rows(shape: Tuple[int, ...], native_bits: int = 8
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray, np.ndarray]:
    """Feasible placeholder mapping arrays for padded rows/models with any
    leading ``shape``: unit tiles, identity order, the (K, C) pair, a 1x1
    array, the native operand width."""
    tiles = np.ones(shape + (NUM_DIMS,), np.int32)
    orders = np.tile(np.arange(NUM_DIMS, dtype=np.int32), shape + (1,))
    pairs = np.tile(np.asarray([0, 1], np.int32), shape + (1,))
    shapes = np.ones(shape + (2,), np.int32)
    reprs = np.full(shape, native_bits, np.int32)
    return tiles, orders, pairs, shapes, reprs


def evaluate_fixed_genome_many(
        requests: Sequence[Tuple[Sequence[Layer], FlexSpec, np.ndarray]],
        device=None) -> List[ModelResult]:
    """Replay fixed mapping configs on many models in one chunked pass.

    Each request is ``(layers, spec, genome)``; all specs must share an
    HWConfig.  The (model, layer) rows of every request are flattened into
    one row list and evaluated through ``evaluate_rows`` in ``ROW_BUCKET``
    chunks on ``device``.  With a device pool (``REPRO_DEVICES``) chunk
    *i* runs on pool device ``i % D`` and up to one chunk per device stays
    in flight.  Rows are independent, so per-request results are
    bit-identical to per-model :func:`evaluate_fixed_genome` calls —
    pooled or not."""
    reqs = [(list(layers), spec, np.asarray(genome))
            for layers, spec, genome in requests]
    if not reqs:
        return []
    device = resolve_device(device)
    hw = reqs[0][1].hw
    if any(spec.hw != hw for _, spec, _ in reqs):
        raise ValueError("replay requests must share an HWConfig")

    row_data = []          # per-row decoded arrays
    mappings = []
    bounds: List[Tuple[int, int]] = []
    for layers, spec, genome in reqs:
        start = len(row_data)
        for layer in layers:
            space = mapspace_for(layer, spec)
            g = space.clip(genome[None, :])
            t, o, p, s_, r = space.decode_batch(g)
            row_data.append((space.dims, layer.stride, layer.depthwise,
                             t[0], o[0], p[0], s_[0], space.hard_partition,
                             r[0]))
            mappings.append(space.decode(g[0]))
        bounds.append((start, len(row_data)))

    pool = device_pool.default_pool(device)
    pieces: List[CostResult] = []

    def materialize(n, res):
        pieces.append(CostResult(*(f.cpu().numpy()[:n] for f in res)))
        return ()

    # one in-flight chunk per pool device (1 without a pool): round-robin
    # dispatch with bounded backpressure, so device memory stays at ~pool
    # depth chunks however large the replay is
    queue = InFlightQueue(depth=len(pool) if pool else 1,
                          collect=materialize)
    for ci, c0 in enumerate(range(0, len(row_data), ROW_BUCKET)):
        chunk = row_data[c0:c0 + ROW_BUCKET]
        n_pad = ROW_BUCKET
        dims = np.ones((n_pad, 6), np.int32)
        stride = np.ones(n_pad, np.int32)
        dw = np.zeros(n_pad, np.bool_)
        tiles, orders, pairs, shapes, reprs = _inert_mapping_rows(
            (n_pad,), 8 * hw.bytes_per_elem)
        hp = np.zeros(n_pad, np.bool_)
        for i, (d_, st_, w_, t, o, p, sh, h, r) in enumerate(chunk):
            dims[i], stride[i], dw[i] = d_, st_, w_
            tiles[i], orders[i], pairs[i], shapes[i], hp[i] = t, o, p, sh, h
            reprs[i] = r
        # all-native chunks replay without width scaling (reference parity)
        r_live = bool((reprs != 8 * hw.bytes_per_elem).any())
        dev = pool.device_for(ci) if pool else device

        def up(a):
            return torch.as_tensor(a, device=dev)

        queue.push(len(chunk), evaluate_rows(
            up(dims), up(stride), up(dw), up(tiles), up(orders), up(pairs),
            up(shapes), up(hp), hw, up(reprs) if r_live else None))
    queue.drain()

    if pieces:
        res = CostResult(*(np.concatenate([p[f] for p in pieces])
                           for f in range(len(CostResult._fields))))
    out: List[ModelResult] = []
    for start, end in bounds:
        per_layer = [MapperResult(
            mapping=mappings[j],
            runtime=float(res.runtime[j]), energy=float(res.energy[j]),
            edp=float(res.edp[j]), util=float(res.util[j]),
            dram_elems=float(res.dram_elems[j]),
            feasible=bool(res.feasible[j]), history=[])
            for j in range(start, end)]
        out.append(_model_result(per_layer))
    return out


def evaluate_fixed_genome(layers: Sequence[Layer], spec: FlexSpec,
                          genome: np.ndarray, device=None) -> ModelResult:
    """Run ONE mapping config on every layer (what an InFlex accel does):
    single-request case of :func:`evaluate_fixed_genome_many`."""
    return evaluate_fixed_genome_many([(layers, spec, genome)], device)[0]


# rows of one block of XLA's CPU reduction over a major axis
_REDUCE_BLOCK = 32


def _layer_sum(v: torch.Tensor) -> torch.Tensor:
    """float32 sum over axis 1 of ``v`` (M, L, P) in the order XLA's CPU
    backend reduces a major axis: blocks of 32 rows, each summed in row
    order, then the block sums added in order.  Past 2**24 a float32 sum
    depends on its order, and the GA ranks on these sums."""
    total = torch.zeros_like(v[:, 0])
    for b0 in range(0, v.shape[1], _REDUCE_BLOCK):
        part = torch.zeros_like(v[:, 0])
        for li in range(b0, min(b0 + _REDUCE_BLOCK, v.shape[1])):
            part = part + v[:, li]
        total = total + part
    return total


def _fixed_configs_objective(dims, strides, dws, mask, tiles, orders, pairs,
                             shapes, reprs, hw: HWConfig,
                             hard_partition: bool,
                             objective: str) -> torch.Tensor:
    """Whole-model objective of each model's shared mapping population.

    Shapes: dims (M, L, 6), strides/dws/mask (M, L), tiles (M, P, 6),
    orders (M, P, 6), pairs/shapes (M, P, 2), reprs (M, P) or None (native
    width: evaluated without width scaling, the reference's parity rule).
    Every (model, layer, mapping) is costed in one broadcast pass; the
    masked layer sum takes the order of the reference's jitted reduction
    (:func:`_layer_sum`), and infeasible raw tiles take the 1e30 penalty.
    Returns the (M, P) objective."""
    res = evaluate_mapping_impl(
        dims[:, :, None, :], strides[:, :, None], dws[:, :, None],
        tiles[:, None], orders[:, None], pairs[:, None], shapes[:, None],
        hw, hard_partition, None if reprs is None else reprs[:, None])
    m = mask.to(torch.float32)[:, :, None]
    runtime = _layer_sum(res.runtime * m)
    energy = _layer_sum(res.energy * m)
    ok = raw_tile_feasibility(tiles, float(hw.buffer_elems))
    penalty = torch.where(ok, 0.0, 1e30)
    runtime = runtime + penalty
    energy = energy + penalty
    return {"runtime": runtime, "energy": energy,
            "edp": runtime * energy}[objective]


@dataclasses.dataclass
class _FixedConfigState:
    """Per-model host state of one fixed-config GA (campaign batching)."""

    layers: List[Layer]
    spec: FlexSpec
    space: MapSpace
    ops: _Operators
    rng: np.random.Generator
    dims: np.ndarray
    strides: np.ndarray
    dws: np.ndarray
    mask: np.ndarray
    pop: np.ndarray
    best_obj: float = np.inf
    best_g: Optional[np.ndarray] = None


def _fixed_config_state(layers: Sequence[Layer], spec: FlexSpec,
                        cfg: GAConfig) -> _FixedConfigState:
    """Build one model's GA state exactly as the single-model search does:
    same rng seeding order (state construction, then the population
    sample), so the campaign path consumes identical random streams."""
    rng = np.random.default_rng(cfg.seed)
    # use the largest layer's space for sampling bounds
    dims_mat = layers_as_array(layers)
    probe = Layer("probe", tuple(int(v) for v in dims_mat.max(axis=0)))
    space = MapSpace(probe, spec)
    ops = _Operators(space, cfg, rng)

    n = len(layers)
    n_pad = _bucket(max(n, 1), ROW_BUCKET)
    dims = np.ones((n_pad, 6), np.int32)
    dims[:n] = dims_mat
    strides = np.ones(n_pad, np.int32)
    strides[:n] = [l.stride for l in layers]
    dws = np.zeros(n_pad, np.bool_)
    dws[:n] = [l.depthwise for l in layers]
    mask = np.zeros(n_pad, np.bool_)
    mask[:n] = True
    pop = space.sample(rng, cfg.population)
    return _FixedConfigState(layers=list(layers), spec=spec, space=space,
                             ops=ops, rng=rng, dims=dims, strides=strides,
                             dws=dws, mask=mask, pop=pop)


def search_fixed_configs(
        requests: Sequence[Tuple[Sequence[Layer], FlexSpec]],
        cfg: Optional[GAConfig] = None, device=None
        ) -> List[Tuple[np.ndarray, ModelResult]]:
    """Fixed-config DSE for many models at once (fig13's InFlex-0000-X-Opt
    row as one campaign).

    Models are grouped into shape buckets — same padded layer count, same
    hard-partition flag — and each bucket's populations are stacked into
    one (M, P, 10) genome tensor: each generation is ONE objective pass on
    ``device`` for the whole bucket.  Selection, crossover and mutation stay
    host-side per model with each model's own Generator (seeded
    ``cfg.seed``), so every model's genome trajectory — and therefore the
    returned design — is bit-identical to its own
    :func:`search_fixed_config` call."""
    cfg = cfg or GAConfig()
    device = resolve_device(device)
    requests = [(list(layers), spec) for layers, spec in requests]
    if not requests:
        raise ValueError("need at least one request")
    hw = requests[0][1].hw
    if any(spec.hw != hw for _, spec in requests):
        raise ValueError("fixed-config campaign requests must share an "
                         "HWConfig")
    states = [_fixed_config_state(layers, spec, cfg)
              for layers, spec in requests]

    def up(a):
        return torch.as_tensor(a, device=device)

    n_elite = ga_ops.n_elite(cfg)
    n_children = cfg.population - n_elite
    native = 8 * hw.bytes_per_elem
    groups: Dict[tuple, List[_FixedConfigState]] = {}
    for st in states:
        key = (st.dims.shape[0], st.space.hard_partition)
        groups.setdefault(key, []).append(st)

    for (_, hard), group in groups.items():
        dims_b = up(np.stack([s.dims for s in group]))
        strides_b = up(np.stack([s.strides for s in group]))
        dws_b = up(np.stack([s.dws for s in group]))
        mask_b = up(np.stack([s.mask for s in group]))
        for _ in range(cfg.generations):
            decoded = [s.space.decode_batch(s.pop) for s in group]
            tiles_b, orders_b, pairs_b, shapes_b, reprs_b = (
                np.stack(f) for f in zip(*decoded))
            r_live = bool((reprs_b != native).any())
            obj_b = _fixed_configs_objective(
                dims_b, strides_b, dws_b, mask_b, up(tiles_b),
                up(orders_b), up(pairs_b), up(shapes_b),
                up(reprs_b) if r_live else None, hw, hard,
                cfg.objective).cpu().numpy()
            for s, obj in zip(group, obj_b):
                order_idx = np.argsort(obj, kind="stable")
                if obj[order_idx[0]] < s.best_obj:
                    s.best_obj = float(obj[order_idx[0]])
                    s.best_g = s.pop[order_idx[0]].copy()
                elites = s.pop[order_idx[:n_elite]]
                ranks = s.rng.choice(cfg.population, n_children,
                                     p=ga_ops.rank_probs(cfg.population))
                children = s.ops.mutate(s.ops.crossover(
                    s.pop[order_idx[ranks]]))
                s.pop = np.concatenate([elites, children], axis=0)

    replays = evaluate_fixed_genome_many(
        [(s.layers, s.spec, s.best_g) for s in states], device)
    return [(s.best_g, r) for s, r in zip(states, replays)]


def search_fixed_config(layers: Sequence[Layer], spec: FlexSpec,
                        cfg: Optional[GAConfig] = None, device=None
                        ) -> Tuple[np.ndarray, ModelResult]:
    """DSE for an *inflexible* accelerator: find the single TOPS config that
    minimizes whole-model runtime (paper Sec 7, InFlex-0000-X-Opt).  The
    genome is shared across layers; per-layer tile clipping applies.
    Single-model case of :func:`search_fixed_configs`."""
    return search_fixed_configs([(layers, spec)], cfg, device)[0]
