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
from . import ga_ops
from .cost_model import CostResult, evaluate_population
from .engine import EngineRow, run_batched_ga
from .mapspace import Mapping, mapspace_for
from .spec import FlexSpec
from .workloads import Layer

ENGINES = ("batched", "serial")


def _parse_device_spec(spec) -> Optional[Tuple[int, ...]]:
    """The device-pool grammar of the JAX package (``None`` / ``""``, a
    count, ``"all"``, or explicit indices), used here only to validate
    ``GAConfig.devices``; the pool itself is ROADMAP slice 3."""
    if spec is None:
        return None
    if isinstance(spec, str):
        spec = spec.strip()
        if not spec:
            return None
        if spec.lower() == "all":
            return ()
        if "," in spec:
            spec = [int(p) for p in spec.split(",") if p.strip()]
        else:
            spec = int(spec)
    if isinstance(spec, bool):
        raise ValueError(f"invalid device spec {spec!r}")
    if isinstance(spec, int):
        if spec < 1:
            raise ValueError(f"device count must be >= 1, got {spec}")
        return tuple(range(spec))
    idx = tuple(int(i) for i in spec)
    if not idx:
        raise ValueError("explicit device index list must not be empty")
    if any(i < 0 for i in idx):
        raise ValueError(f"device indices must be >= 0, got {idx}")
    return idx


def _normalize_devices(devices):
    """Canonicalize ``GAConfig.devices`` to a hashable form (int count,
    index tuple, or stripped string) and validate it at construction."""
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
    _parse_device_spec(devices)             # raises ValueError on garbage
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
                                # (needs the in-flight queue: slice 3)
    devices: Optional[object] = None
                                # device pool for engine chunks: a count,
                                # "all", or tuple of device indices (needs
                                # the device pool: slice 3)

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
    only ever clip DOWN on a layer).  tiles: (P, 6) raw genome tile genes;
    returns a (P,) bool mask."""
    t = tiles.to(torch.float32)
    in_vol = t[:, 1] * (t[:, 2] - 1 + t[:, 4]) * (t[:, 3] - 1 + t[:, 5])
    w_vol = t[:, 0] * t[:, 1] * t[:, 4] * t[:, 5]
    o_vol = t[:, 0] * t[:, 2] * t[:, 3]
    return (in_vol + w_vol + o_vol) <= buffer_elems
