"""Genome -> Hopper kernel lowering: the model-to-measurement bridge.

The mapper ranks 10-gene ``Mapping`` genomes with the analytical cost model;
this module makes those genomes *executable*.  It lowers a mapping onto the
knobs the hand-written kernels expose, checks the lowered config against
the same legality the cost model enforces, and closes the loop with a
measured-runtime objective the GA can optimize directly:

  T genes  -> ``tiled_matmul`` block shapes ``(bm, bn, bk)``,
              ``flash_attention`` tiles ``(bq, bkv)``,
              ``mamba_scan`` chunking ``(chunk, d_block)``
  O gene   -> ``tiled_matmul`` stationarity order ("out" / "a" / "b")
  R gene   -> executed kernel dtype via ``kernels.kernel_bits`` and the
              width-aware ``smem_bytes`` of each kernel
              (``precision.bytes_of``)

Lowering is TOTAL and deterministic: every genome the cost model can rate —
feasible or not — snaps to a legal config (``_snap_block`` always finds a
divisor, and ``lower_mapping`` shrinks blocks until the shared-memory budget
holds).  The buffer-side legality the mapper applies
(``raw_tile_feasibility``) is mirrored here in numpy
(``bridge_tile_feasible``) with the identical float32 arithmetic.

``MeasuredRunner`` times lowered kernels on the card (CUDA events) behind a
``ResultCache`` timing cache, and ``tune_kernel`` runs the serial GA with
measured time as the objective — falling back to the modeled objective when
no card runs the kernels (a CPU device, or ``REPRO_NO_KERNELS=1``).
``rank_correlation_study`` records how well the model's predicted cost
ranks measured cost per mapping.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels as _k
from ..device import resolve_device
from ..kernels.flash_attention import smem_bytes as attention_smem_bytes
from ..kernels.mamba_scan import smem_bytes as mamba_smem_bytes
from ..kernels.tiled_matmul import smem_bytes as matmul_smem_bytes
from . import ga_ops
from .envvars import get_env
from .mapper import GAConfig
from .mapspace import Mapping, MapSpace, mapspace_for
from .precision import bytes_of
from .result_cache import ResultCache
from .spec import FlexSpec
from .workloads import Layer, gemm

# Block edges snap to multiples of this when the dim offers one: 16 is the
# M and K edge of the Hopper tensor-core tiles a faster kernel would issue
# (mma.sync m16n8k16; wgmma's K depth of 16 bf16 values — PTX ISA, warp-level
# matrix shapes) and a whole number of 16-byte vector loads at every
# executed width.  Smaller blocks are accepted only when no aligned divisor
# fits, so lowering stays total.
TILE_ALIGN = 16

# Dynamic shared memory one block may request on an H100: 227 KB
# (232,448 bytes) opt-in (CUDA C++ Programming Guide, compute capability 9.0
# technical specifications).
SMEM_BUDGET_BYTES = 232_448

BIG = 1e30


# --------------------------------------------------------------------------
# Workloads: the kernel-side view of a layer
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelWorkload:
    """One executable kernel instance plus its cost-model Layer twin.

    ``shape`` is kind-specific: matmul ``(m, n, k)``; attention
    ``(heads, seq, head_dim)``; mamba ``(batch, seq, d_inner, d_state)``.
    """

    kind: str                    # "matmul" | "attention" | "mamba"
    shape: Tuple[int, ...]

    @property
    def layer(self) -> Layer:
        """The GEMM-normalized Layer the mapper searches: matmul
        (K=M, C=Kred, Y=N); attention scores (K=Sq, C=d, Y=Skv); mamba
        (K=D, C=N, Y=L)."""
        if self.kind == "matmul":
            m, n, k = self.shape
            return gemm(f"mm_{m}x{n}x{k}", m, n, k)
        if self.kind == "attention":
            h, s, d = self.shape
            return gemm(f"attn_h{h}_s{s}_d{d}", s, s, d)
        if self.kind == "mamba":
            b, length, d, n = self.shape
            return gemm(f"mamba_b{b}_l{length}_d{d}_n{n}", d, length, n)
        raise ValueError(f"unknown kernel kind {self.kind!r}")


def matmul_workload(m: int, n: int, k: int) -> KernelWorkload:
    return KernelWorkload("matmul", (m, n, k))


def attention_workload(heads: int, seq: int, head_dim: int
                       ) -> KernelWorkload:
    return KernelWorkload("attention", (heads, seq, head_dim))


def mamba_workload(batch: int, seq: int, d_inner: int, d_state: int
                   ) -> KernelWorkload:
    return KernelWorkload("mamba", (batch, seq, d_inner, d_state))


# --------------------------------------------------------------------------
# Lowering
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """A fully lowered, executable kernel configuration."""

    kind: str
    block: Tuple[int, ...]       # matmul (bm, bn, bk); attention (bq, bkv);
                                 # mamba (chunk, d_block)
    order: str                   # matmul stationarity; "" for other kinds
    bits: int                    # executed operand width (kernel_bits)

    def cache_key(self, wl: KernelWorkload) -> tuple:
        return ("kernel-timing", self.kind, wl.shape, self.block,
                self.order, self.bits)


def _snap_block(dim: int, target: int, align: Optional[int] = None) -> int:
    """Largest divisor of ``dim`` that is <= ``target``, preferring
    ``align``-multiples (default :data:`TILE_ALIGN`, read at call time) when
    the dim offers one.  Total: 1 always divides."""
    align = TILE_ALIGN if align is None else align
    dim = int(dim)
    target = max(1, min(int(target), dim))
    divs = [int(d) for d in ga_ops.divisors(dim) if d <= target]
    aligned = [d for d in divs if d % align == 0]
    return (aligned or divs)[-1]


def _matmul_order(order_perm: Tuple[int, ...]) -> str:
    """O gene -> stationarity: the innermost of the GEMM dims K(=M-dim 0),
    C(=reduction dim 1), Y(=N-dim 2) in the loop order decides which operand
    stays resident."""
    pos = {d: i for i, d in enumerate(order_perm)}
    innermost = max((0, 1, 2), key=lambda d: pos[d])
    return {1: "out", 2: "a", 0: "b"}[innermost]


def _vmem(kind: str, shape: Tuple[int, ...], block: Tuple[int, ...],
          bits: int) -> float:
    """Width-aware shared memory of a lowered config: the most the kernel
    launch may request (each kind's ``smem_bytes``, looked up through this
    module's names at call time; the float32 matmul requests at most
    this)."""
    db = bytes_of(bits)
    if kind == "matmul":
        bm, bn, bk = block
        return matmul_smem_bytes(bm, bn, bk, db)
    if kind == "attention":
        bq, bkv = block
        return attention_smem_bytes(bq, bkv, shape[2], db)
    chunk, d_block = block
    return mamba_smem_bytes(chunk, d_block, shape[3], db)


def _block_dims(wl: KernelWorkload) -> Tuple[int, ...]:
    """The workload dim each block component must divide."""
    if wl.kind == "matmul":
        m, n, k = wl.shape
        return (m, n, k)
    if wl.kind == "attention":
        return (wl.shape[1], wl.shape[1])
    return (wl.shape[1], wl.shape[2])         # (L, D)


def lower_mapping(wl: KernelWorkload, mapping: Mapping) -> KernelConfig:
    """Lower one Mapping onto the workload's kernel knobs.

    T genes are read through the same GEMM normalization the Layer uses
    (gene 0 = K-dim tile, 1 = C/reduction, 2 = Y-dim), snapped to
    aligned divisors; blocks then shrink (largest first) until the
    shared-memory budget holds, so the result is always ``config_legal``.
    """
    t = mapping.tiles
    if wl.kind == "matmul":
        m, n, k = wl.shape
        block = [_snap_block(m, t[0]), _snap_block(n, t[2]),
                 _snap_block(k, t[1])]
        order = _matmul_order(mapping.order)
    elif wl.kind == "attention":
        s = wl.shape[1]
        block = [_snap_block(s, t[0]), _snap_block(s, t[2])]
        order = ""
    elif wl.kind == "mamba":
        _, length, d, _ = wl.shape
        block = [_snap_block(length, t[2]), _snap_block(d, t[0])]
        order = ""
    else:
        raise ValueError(f"unknown kernel kind {wl.kind!r}")
    bits = _k.kernel_bits(int(mapping.repr_bits), wl.kind)

    dims = _block_dims(wl)
    while (_vmem(wl.kind, wl.shape, tuple(block), bits)
           > SMEM_BUDGET_BYTES and max(block) > 1):
        i = int(np.argmax(block))
        block[i] = _snap_block(dims[i], block[i] // 2)
    return KernelConfig(kind=wl.kind, block=tuple(block), order=order,
                        bits=bits)


def lower_genome(wl: KernelWorkload, space: MapSpace,
                 genome: np.ndarray) -> KernelConfig:
    return lower_mapping(wl, space.decode(np.asarray(genome)))


def config_legal(wl: KernelWorkload, cfg: KernelConfig) -> bool:
    """The lowered-config legality predicate: per-block divisibility with
    the alignment preference (a block is acceptable iff it is its own snap
    fixpoint), the width-aware shared-memory budget, and — for matmul — a
    known stationarity order.  ``lower_mapping`` output satisfies this for
    every genome (totality)."""
    dims = _block_dims(wl)
    if len(cfg.block) != len(dims):
        return False
    for dim, b in zip(dims, cfg.block):
        if b < 1 or dim % b != 0 or b != _snap_block(dim, b):
            return False
    if cfg.kind == "matmul" and cfg.order not in ("out", "a", "b"):
        return False
    if cfg.bits not in _k.SUPPORTED_BITS[cfg.kind]:
        return False
    return _vmem(cfg.kind, wl.shape, cfg.block, cfg.bits) \
        <= SMEM_BUDGET_BYTES


def bridge_tile_feasible(tiles: np.ndarray,
                         buffer_elems: float) -> np.ndarray:
    """Numpy mirror of ``mapper.raw_tile_feasibility`` — the SAME float32
    volume arithmetic, term for term.  tiles: (..., 6); returns (...,)
    bool."""
    t = np.asarray(tiles, np.float32)
    in_vol = t[..., 1] * (t[..., 2] - 1 + t[..., 4]) * \
        (t[..., 3] - 1 + t[..., 5])
    w_vol = t[..., 0] * t[..., 1] * t[..., 4] * t[..., 5]
    o_vol = t[..., 0] * t[..., 2] * t[..., 3]
    return (in_vol + w_vol + o_vol) <= np.float32(buffer_elems)


# --------------------------------------------------------------------------
# Predicted cost of a lowered config (the model side of the correlation)
# --------------------------------------------------------------------------

def effective_tiles(wl: KernelWorkload, cfg: KernelConfig
                    ) -> Tuple[int, ...]:
    """The T genes the kernel *actually* executes (lowered blocks mapped
    back through the GEMM normalization)."""
    if wl.kind == "matmul":
        bm, bn, bk = cfg.block
        return (bm, bk, bn, 1, 1, 1)
    if wl.kind == "attention":
        bq, bkv = cfg.block
        return (bq, wl.shape[2], bkv, 1, 1, 1)
    chunk, d_block = cfg.block
    return (d_block, wl.shape[3], chunk, 1, 1, 1)


def predicted_runtime(wl: KernelWorkload, spec: FlexSpec,
                      mapping: Mapping,
                      cfg: Optional[KernelConfig] = None,
                      device=None) -> float:
    """Modeled runtime (cycles) of the mapping AS LOWERED: tiles snapped to
    the executed blocks, repr snapped to the executed width."""
    from .cost_model import evaluate_mapping

    device = resolve_device(device)
    cfg = cfg or lower_mapping(wl, mapping)
    layer = wl.layer

    def t(v, dtype=torch.int32):
        return torch.tensor(v, dtype=dtype, device=device)

    res = evaluate_mapping(
        t(layer.dims), t(layer.stride), t(layer.depthwise, torch.bool),
        t(effective_tiles(wl, cfg)), t(mapping.order), t(mapping.parallel),
        t(mapping.shape), spec.hw, mapspace_for(layer, spec).hard_partition,
        t(float(cfg.bits), torch.float32))
    return float(res.runtime)


# --------------------------------------------------------------------------
# Measurement
# --------------------------------------------------------------------------

def make_inputs(wl: KernelWorkload, seed: int = 0, device=None) -> tuple:
    """Deterministic float32 input tensors for a workload on ``device``
    (the reference's numpy draws, in its order).  Matmul inputs are
    integer-valued in {-1, 0, 1} so the int8-executed R widths cast
    losslessly."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if wl.kind == "matmul":
        m, n, k = wl.shape
        arrays = (rng.integers(-1, 2, (m, k)).astype(np.float32),
                  rng.integers(-1, 2, (k, n)).astype(np.float32))
    elif wl.kind == "attention":
        h, s, d = wl.shape
        arrays = tuple(rng.normal(size=(h, s, d)).astype(np.float32) * 0.5
                       for _ in range(3))
    else:
        b, length, d, n = wl.shape
        x = rng.normal(size=(b, length, d)).astype(np.float32) * 0.5
        dt = rng.uniform(0.001, 0.1, (b, length, d)).astype(np.float32)
        bb = rng.normal(size=(b, length, n)).astype(np.float32) * 0.5
        cc = rng.normal(size=(b, length, n)).astype(np.float32) * 0.5
        a_log_neg = -rng.uniform(0.5, 2.0, (d, n)).astype(np.float32)
        d_skip = np.ones((d,), np.float32)
        arrays = (x, dt, bb, cc, a_log_neg, d_skip)
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def run_config(wl: KernelWorkload, cfg: KernelConfig, inputs: tuple,
               use_kernel: bool = True):
    """Execute one lowered config on the inputs' device (the Hopper kernel
    on CUDA tensors, its plain version on CPU tensors)."""
    from ..kernels import ops

    if wl.kind == "matmul":
        x, y = inputs
        bm, bn, bk = cfg.block
        return ops.matmul(x, y, bm=bm, bn=bn, bk=bk, order=cfg.order,
                          bits=cfg.bits, use_kernel=use_kernel)
    if wl.kind == "attention":
        q, k, v = inputs
        bq, bkv = cfg.block
        return ops.attention(q, k, v, causal=True, bq=bq, bkv=bkv,
                             bits=cfg.bits, use_kernel=use_kernel)
    chunk, d_block = cfg.block
    return ops.mamba_scan(*inputs, chunk=chunk, d_block=d_block,
                          bits=cfg.bits, use_kernel=use_kernel)


def reference_output(wl: KernelWorkload, cfg: KernelConfig, inputs: tuple):
    """The oracle's answer on the SAME width-cast operands the kernel sees
    (kernels/ref.py)."""
    from ..kernels import cast, dtype_for_bits, ref

    dt = dtype_for_bits(cfg.bits, wl.kind)
    if wl.kind == "matmul":
        x, y = (cast(a, dt) for a in inputs)
        return ref.matmul_ref(x, y)
    if wl.kind == "attention":
        q, k, v = (cast(a, dt) for a in inputs)
        return ref.attention_ref(q, k, v, causal=True)
    x, dtt, b, c, a_log_neg, d_skip = inputs
    return ref.mamba_scan_ref(cast(x, dt), cast(dtt, dt), cast(b, dt),
                              cast(c, dt), a_log_neg, d_skip)


# (rtol, atol) per executed width — int8 paths are exact on the integer-
# valued matmul inputs; bf16 tolerances follow tests/test_kernels.py.
PARITY_TOLS = {8: (0.0, 0.0), 16: (2e-2, 0.16), 32: (2e-4, 2e-4)}


def parity_check(wl: KernelWorkload, cfg: KernelConfig,
                 inputs: Optional[tuple] = None,
                 device=None) -> Tuple[bool, float]:
    """Golden-model check: lowered kernel vs the kernels/ref oracle within
    the executed width's tolerance.  Returns (ok, max_abs_err)."""
    inputs = inputs if inputs is not None else make_inputs(wl, device=device)
    got = run_config(wl, cfg, inputs).float().cpu().numpy()
    want = reference_output(wl, cfg, inputs).float().cpu().numpy()
    rtol, atol = PARITY_TOLS[cfg.bits]
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    ok = bool(np.allclose(got, want, rtol=rtol, atol=atol))
    return ok, err


class MeasuredRunner:
    """Times lowered kernels behind a ResultCache timing cache.

    ``timer`` injects a fake measurement (key -> seconds) for hermetic,
    bit-reproducible tests; without it, the time is the best of ``repeats``
    calls after ``warmup`` calls, each timed with CUDA events.
    ``force_available`` pins availability for tests; otherwise kernels are
    available on a CUDA ``device`` unless ``REPRO_NO_KERNELS`` is set.
    """

    def __init__(self, cache: Optional[ResultCache] = None,
                 timer: Optional[Callable[[tuple], float]] = None,
                 repeats: int = 3, warmup: int = 1, input_seed: int = 0,
                 force_available: Optional[bool] = None, device=None):
        self.cache = cache if cache is not None else ResultCache()
        self.timer = timer
        self.repeats = max(1, int(repeats))
        self.warmup = max(0, int(warmup))
        self.input_seed = input_seed
        self.force_available = force_available
        self.device = resolve_device(device)
        self._inputs: Dict[KernelWorkload, tuple] = {}
        # every (workload, config) timed, in order (the cache misses)
        self.timed: List[Tuple[KernelWorkload, KernelConfig]] = []

    def available(self) -> bool:
        if self.force_available is not None:
            return bool(self.force_available)
        if get_env("REPRO_NO_KERNELS"):
            return False
        return self.device.type == "cuda"

    def inputs_for(self, wl: KernelWorkload) -> tuple:
        if wl not in self._inputs:
            self._inputs[wl] = make_inputs(wl, self.input_seed, self.device)
        return self._inputs[wl]

    def _time(self, wl: KernelWorkload, cfg: KernelConfig) -> float:
        inputs = self.inputs_for(wl)
        cuda = self.device.type == "cuda"
        for _ in range(self.warmup):
            run_config(wl, cfg, inputs)
        best = np.inf
        for _ in range(self.repeats):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run_config(wl, cfg, inputs)
                end.record()
                end.synchronize()
                seconds = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                run_config(wl, cfg, inputs)
                seconds = time.perf_counter() - t0
            best = min(best, seconds)
        return float(best)

    def measure(self, wl: KernelWorkload, cfg: KernelConfig) -> float:
        """Seconds for one call of the lowered config (cached per config)."""
        key = cfg.cache_key(wl)
        hit = self.cache.get(key)
        if hit is not None:
            return float(hit)
        self.timed.append((wl, cfg))
        t = (float(self.timer(key)) if self.timer is not None
             else self._time(wl, cfg))
        return float(self.cache.merge(key, t))


# --------------------------------------------------------------------------
# Measured-objective GA tuning
# --------------------------------------------------------------------------

class TuneResult(NamedTuple):
    config: KernelConfig
    mapping: Mapping
    genome: np.ndarray
    objective: str               # "measured" | "modeled"
    best_cost: float             # seconds (measured) or cycles (modeled)
    predicted: float             # modeled runtime of the winner, as lowered
    history: Tuple[float, ...]   # best objective per generation
    measured_configs: int        # distinct configs actually timed


# Small default budget: the timing cache dedups a population heavily, so
# few generations over a small population measure few distinct configs.
TUNE_CFG = GAConfig(population=12, generations=6, engine="serial")


def tune_kernel(wl: KernelWorkload, spec: FlexSpec,
                cfg: Optional[GAConfig] = None,
                runner: Optional[MeasuredRunner] = None,
                device=None) -> TuneResult:
    """GA search over the map space with MEASURED kernel time as the
    objective (modeled runtime when the runner has no kernels to time).

    Walks the exact serial-engine trajectory — same seeded draw stream,
    same ``ga_ops.next_population`` breeding step — with the per-genome
    objective swapped: cost-model-feasible genomes are lowered and timed
    (deduped through the runner's timing cache), infeasible ones keep the
    model's BIG-penalized runtime so they can never win.  The cost model
    runs on the runner's device (``device`` when no runner is given).
    """
    from .cost_model import evaluate_population

    cfg = cfg or TUNE_CFG
    runner = runner if runner is not None else MeasuredRunner(device=device)
    device = runner.device
    measured = runner.available()

    layer = wl.layer
    space = mapspace_for(layer, spec)
    rng = np.random.default_rng(cfg.seed)
    pop = ga_ops.initial_population(rng, space, cfg)
    n_elite = ga_ops.n_elite(cfg)
    draws = ga_ops.draw_run(rng, space, cfg, cfg.generations,
                            cfg.population - n_elite)
    lens = space.table_lens()

    def up(a):
        return torch.as_tensor(a, device=device)

    dims, stride, dw = (up(np.asarray(layer.dims)), up(layer.stride),
                        up(layer.depthwise))
    r_live = (len(space.repr_table) > 1
              or int(space.repr_table[0]) != 8 * spec.hw.bytes_per_elem)

    history: List[float] = []
    best_obj = np.inf
    best_g: Optional[np.ndarray] = None

    for gen in range(cfg.generations):
        tiles, orders, pairs, shapes, reprs = space.decode_batch(pop)
        res = evaluate_population(
            dims, stride, dw, up(tiles), up(orders), up(pairs), up(shapes),
            spec.hw, space.hard_partition, up(reprs) if r_live else None)
        modeled = res.runtime.cpu().numpy().astype(np.float64)
        feasible = res.feasible.cpu().numpy()
        if measured:
            obj = modeled.copy()     # infeasible keep the BIG penalty
            for i in np.nonzero(feasible)[0]:
                obj[i] = runner.measure(wl, lower_genome(wl, space, pop[i]))
        else:
            obj = modeled
        order_idx = np.argsort(obj, kind="stable")
        if obj[order_idx[0]] < best_obj:
            best_obj = float(obj[order_idx[0]])
            best_g = pop[order_idx[0]].copy()
        history.append(best_obj)

        pop = ga_ops.next_population(pop, order_idx,
                                     ga_ops.gen_slice(draws, gen),
                                     space.tile_lo, space.tile_hi, lens,
                                     n_elite, np)

    assert best_g is not None
    mapping = space.decode(best_g)
    kcfg = lower_mapping(wl, mapping)
    return TuneResult(
        config=kcfg, mapping=mapping, genome=best_g,
        objective="measured" if measured else "modeled",
        best_cost=best_obj,
        predicted=predicted_runtime(wl, spec, mapping, kcfg, device),
        history=tuple(history),
        measured_configs=len(runner.cache) if measured else 0,
    )


# --------------------------------------------------------------------------
# Predicted-vs-measured rank correlation
# --------------------------------------------------------------------------

def _avg_ranks(v: np.ndarray) -> np.ndarray:
    """Average ranks with tie sharing."""
    v = np.asarray(v, np.float64)
    order = np.argsort(v, kind="stable")
    ranks = np.empty(len(v), np.float64)
    i = 0
    sv = v[order]
    while i < len(sv):
        j = i
        while j + 1 < len(sv) and sv[j + 1] == sv[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0
        i = j + 1
    return ranks


def spearman(a, b) -> float:
    """Spearman rank correlation (average-rank Pearson); 0.0 when either
    side is constant."""
    ra, rb = _avg_ranks(a), _avg_ranks(b)
    ra = ra - ra.mean()
    rb = rb - rb.mean()
    denom = float(np.sqrt((ra * ra).sum() * (rb * rb).sum()))
    if denom == 0.0:
        return 0.0
    return float((ra * rb).sum() / denom)


def rank_correlation_study(wl: KernelWorkload, spec: FlexSpec,
                           n_samples: int = 16, seed: int = 0,
                           runner: Optional[MeasuredRunner] = None,
                           device=None) -> dict:
    """Sample genomes, lower them, and correlate model-predicted runtime
    with measured time per DISTINCT lowered config.  The sampled genomes,
    lowered configs and predicted costs are deterministic; only the
    measured seconds depend on the machine."""
    runner = runner if runner is not None else MeasuredRunner(device=device)
    space = mapspace_for(wl.layer, spec)
    rng = np.random.default_rng(seed)
    genomes = space.clip(space.sample(rng, n_samples))

    configs: List[KernelConfig] = []
    predicted: List[float] = []
    seen: Dict[KernelConfig, int] = {}
    for g in genomes:
        mapping = space.decode(g)
        kcfg = lower_mapping(wl, mapping)
        if kcfg in seen:
            continue
        seen[kcfg] = len(configs)
        configs.append(kcfg)
        predicted.append(predicted_runtime(wl, spec, mapping, kcfg,
                                           runner.device))

    measured = [runner.measure(wl, kcfg) for kcfg in configs]
    corr = spearman(predicted, measured) if len(configs) >= 2 else 0.0
    legal = all(config_legal(wl, kcfg) for kcfg in configs)
    return {
        "kind": wl.kind,
        "n_sampled": int(n_samples),
        "n_configs": len(configs),
        "all_legal": legal,
        "spearman": float(corr),
        "configs": configs,
        "predicted": predicted,
        "measured": measured,
    }
