"""Shared GA randomness and operators for the serial and batched MSE engines.

The golden-parity contract between ``mapper.search_model(engine="serial")``
and the batched engine (``repro_torch.core.engine``) rests on two rules
enforced by this module:

  1. **One random stream per (layer, spec) row.**  All data-independent
     randomness of a GA run — parent-selection ranks, crossover masks and
     permutations, mutation masks/steps/divisor snaps — is drawn up front by
     :func:`draw_run` from a single ``numpy`` Generator, in one fixed call
     order.  Both engines call the same function with the same seed, so they
     consume bit-identical draws no matter how the generations are executed.

  2. **One operator formula, two array backends.**  The apply functions below
     (`apply_crossover`, `apply_mutation`, `clip_genomes`) are written against
     the numpy names listed by :class:`TorchXP` and take the backend as the
     ``xp`` argument: ``numpy`` itself, or :data:`TORCH`, which gives those
     names on torch tensors.  Genomes are integers (exact in both backends)
     and the only floating-point arithmetic — the geometric tile step
     ``round(tile * step)`` — is forced to float32 on both sides, so the
     serial host loop and the device loop produce identical genomes.

Rank-based parent selection is expressed as draws of *sorted positions* from
the fixed rank distribution (the probability of picking the j-th best genome
depends only on j), which makes the draw data-independent; engines turn a
position into a genome index via their own stable argsort.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .workloads import NUM_DIMS

GENOME_LEN = 10
N_IDX = 4  # index genes: order / parallel-pair / shape / representation


class GenDraws(NamedTuple):
    """All randomness for a GA run (or one generation when sliced with
    :func:`gen_slice`).  Leading axis of every field is the generation."""

    ranks: np.ndarray       # (G, Pc)     i32  rank-selection sorted positions
    perm: np.ndarray        # (G, Pc)     i32  crossover mate permutation
    cross_mask: np.ndarray  # (G, Pc, 10) bool per-gene swap mask
    cross_do: np.ndarray    # (G, Pc)     bool whether a child crosses at all
    m_tile: np.ndarray      # (G, Pc, 6)  bool tile-gene mutation mask
    step: np.ndarray        # (G, Pc, 6)  f32  geometric tile step factor
    snap: np.ndarray        # (G, Pc, 6)  bool snap-to-divisor mask
    dv: np.ndarray          # (G, Pc, 6)  i32  divisor value snapped to
    m_idx: np.ndarray       # (G, Pc, 4)  bool index-gene mutation mask
    walk: np.ndarray        # (G, Pc, 4)  bool +-1 walk (vs resample)
    stepdir: np.ndarray     # (G, Pc, 4)  i32  walk direction (+-1)
    sampled: np.ndarray     # (G, Pc, 4)  i32  resample target index


def gen_slice(draws: GenDraws, g: int) -> GenDraws:
    """The g-th generation's draws (drops the leading axis)."""
    return GenDraws(*(f[g] for f in draws))


def empty_draw_stack(gens_pad: int, n_rows: int, n_children: int) -> GenDraws:
    """Inert (zero/one) draw arrays for a padded engine chunk: rows past the
    true row count and generations past the fori_loop bound are never
    executed, so their contents only need shape-stable placeholders.  Shared
    by every chunk-preparation path (plain and pipelined)."""
    shape = (gens_pad, n_rows, n_children)
    return GenDraws(
        ranks=np.zeros(shape, np.int32),
        perm=np.zeros(shape, np.int32),
        cross_mask=np.zeros(shape + (GENOME_LEN,), np.bool_),
        cross_do=np.zeros(shape, np.bool_),
        m_tile=np.zeros(shape + (NUM_DIMS,), np.bool_),
        step=np.ones(shape + (NUM_DIMS,), np.float32),
        snap=np.zeros(shape + (NUM_DIMS,), np.bool_),
        dv=np.ones(shape + (NUM_DIMS,), np.int32),
        m_idx=np.zeros(shape + (N_IDX,), np.bool_),
        walk=np.zeros(shape + (N_IDX,), np.bool_),
        stepdir=np.ones(shape + (N_IDX,), np.int32),
        sampled=np.zeros(shape + (N_IDX,), np.int32),
    )


@lru_cache(maxsize=4096)
def divisors(n: int) -> np.ndarray:
    n = int(n)
    return np.asarray([d for d in range(1, n + 1) if n % d == 0], np.int32)


def n_elite(cfg) -> int:
    return max(1, int(cfg.elite_frac * cfg.population))


@lru_cache(maxsize=256)
def rank_probs(population: int) -> np.ndarray:
    """P(select the genome at sorted position j) = (P - j) / sum."""
    p = population - np.arange(population, dtype=np.float64)
    return p / p.sum()


@lru_cache(maxsize=256)
def _rank_cdf(population: int) -> np.ndarray:
    return np.cumsum(rank_probs(population))


# Column layout of the one bulk uniform slab a draw_run consumes (legacy
# T/O/P/S portion — identical to the 9-gene v4 stream):
#   0      parent-rank u        1:10   cross_mask     10     cross_do
#   11:17  m_tile               17:23  snap           23:29  divisor pick
#   29:32  m_idx                32:35  walk           35:38  resample
_U_COLS = 38

# R-axis slab (drawn ONLY when the R table is open, i.e. len > 1):
#   0  cross_mask gene 9        1  m_idx R       2  walk R      3  resample R
_U_R_COLS = 4


def draw_run(rng: np.random.Generator, space, cfg, gens: int,
             n: int) -> GenDraws:
    """Draw every random quantity for ``gens`` generations of ``n`` children.

    Four bulk Generator calls (uniform slab, normal steps, mate
    permutations, walk directions) — a model-level batched search makes one
    ``draw_run`` per row, so per-call Generator overhead is the engine's
    host-side hot path.  Pinned axes (InFlex or unit dims) have their masks
    forced off, so the applied operators never move them; ``space`` supplies
    those constraints (``tile_lo``/``tile_hi``, ``dims``, ``table_lens()``).

    The R-axis slab (two extra calls) is drawn ONLY when the representation
    table is open: a pinned-R run consumes the byte-identical Generator
    stream of the v4 9-gene engine, which is what makes the R-pinned golden
    metrics reproduce bit-identically.  The inert fill (1.0 / +1) makes every
    R-gene predicate false (1.0 < 0.5, 1.0 < rate for rate <= 1).
    """
    u = rng.random((gens, n, _U_COLS))
    normal = rng.normal(0.0, 0.7, (gens, n, NUM_DIMS))
    perm = rng.permuted(
        np.tile(np.arange(n, dtype=np.int32), (gens, 1)), axis=1)
    stepdir = (rng.integers(0, 2, (gens, n, 3), dtype=np.int32) * 2 - 1)

    lens = np.asarray(space.table_lens(), np.int64)             # (4,)
    if lens[3] > 1:
        u_r = rng.random((gens, n, _U_R_COLS))
        stepdir_r = (rng.integers(0, 2, (gens, n, 1), dtype=np.int32) * 2 - 1)
    else:
        u_r = np.ones((gens, n, _U_R_COLS))
        stepdir_r = np.ones((gens, n, 1), np.int32)

    # rank-based parent selection via inverse CDF over sorted positions
    # (clamped: float cumsum can top out a hair below 1.0)
    ranks = np.minimum(
        np.searchsorted(_rank_cdf(cfg.population), u[:, :, 0],
                        side="right"),
        cfg.population - 1).astype(np.int32)
    cross_mask = np.concatenate(
        [u[:, :, 1:10], u_r[:, :, 0:1]], axis=-1) < 0.5
    cross_do = u[:, :, 10] < cfg.crossover_rate

    tile_open = space.tile_lo != space.tile_hi                  # (6,)
    m_tile = (u[:, :, 11:17] < cfg.mutation_rate) & tile_open
    step = np.exp(normal).astype(np.float32)
    snap = (u[:, :, 17:23] < cfg.tile_divisor_bias) & tile_open
    dv = np.ones((gens, n, NUM_DIMS), np.int32)
    for d in np.nonzero(tile_open)[0]:
        divs = divisors(int(space.dims[d]))
        dv[:, :, d] = divs[(u[:, :, 23 + d] * len(divs)).astype(np.int64)]

    idx_open = lens > 1
    u_midx = np.concatenate([u[:, :, 29:32], u_r[:, :, 1:2]], axis=-1)
    m_idx = (u_midx < cfg.mutation_rate) & idx_open
    walk = np.concatenate([u[:, :, 32:35], u_r[:, :, 2:3]], axis=-1) < 0.5
    sampled = (np.concatenate([u[:, :, 35:38], u_r[:, :, 3:4]], axis=-1)
               * lens).astype(np.int32)
    stepdir = np.concatenate([stepdir, stepdir_r], axis=-1)

    return GenDraws(ranks=ranks, perm=perm, cross_mask=cross_mask,
                    cross_do=cross_do, m_tile=m_tile, step=step, snap=snap,
                    dv=dv, m_idx=m_idx, walk=walk, stepdir=stepdir,
                    sampled=sampled)


# --------------------------------------------------------------------------
# Operator formulas — one implementation, numpy or torch via ``xp``.
# The draw fields must already be sliced to one generation (no leading G).
# --------------------------------------------------------------------------

class TorchXP:
    """The numpy names the operators below use, on torch tensors.

    ``mod`` is ``torch.remainder``, which floors like ``np.mod`` (an index
    walk ``idx + stepdir`` can reach -1; ``torch.fmod`` would keep it
    negative).  ``round`` is half-to-even in both backends."""

    float32 = torch.float32
    int32 = torch.int32
    asarray = staticmethod(torch.asarray)
    clip = staticmethod(torch.clip)
    mod = staticmethod(torch.remainder)
    round = staticmethod(torch.round)
    where = staticmethod(torch.where)

    @staticmethod
    def concatenate(arrays, axis=0):
        return torch.cat(arrays, dim=axis)

    @staticmethod
    def take_along_axis(a, idx, axis):
        return torch.take_along_dim(a, idx.long(), dim=axis)

    @staticmethod
    def maximum(a, b):
        return torch.clamp(b, min=a)


TORCH = TorchXP()


def clip_genomes(g, tile_lo, tile_hi, table_lens, xp=np):
    """Project genomes back into the legal axis-constrained space.

    Works on any leading batch shape ``(..., 10)``; ``tile_lo``/``tile_hi``/
    ``table_lens`` broadcast against it (per-row bounds for the batched
    engine, flat vectors for the serial one).
    """
    tiles = xp.clip(g[..., 0:6], tile_lo, tile_hi)
    idx = xp.mod(g[..., 6:10], table_lens)
    return xp.concatenate([tiles, idx], axis=-1)


def apply_crossover(parents, d: GenDraws, xp=np):
    """Uniform crossover against a permuted set of mates (GAMMA-style)."""
    mates = xp.take_along_axis(parents, d.perm[..., None], axis=-2)
    return xp.where(d.cross_do[..., None] & d.cross_mask, mates, parents)


def apply_mutation(g, d: GenDraws, tile_lo, tile_hi, table_lens, xp=np):
    """Tile genes: geometric step or divisor snap; index genes: +-1 walk or
    resample.  float32 step arithmetic on both backends (parity)."""
    tiles = g[..., 0:6]
    stepped = xp.asarray(xp.maximum(
        1.0, xp.round(xp.asarray(tiles, dtype=xp.float32) * d.step)),
        dtype=xp.int32)
    newv = xp.where(d.snap, d.dv, stepped)
    tiles = xp.where(d.m_tile, newv, tiles)
    idx = g[..., 6:10]
    cand = xp.where(d.walk, idx + d.stepdir, d.sampled)
    idx = xp.where(d.m_idx, cand, idx)
    return clip_genomes(xp.concatenate([tiles, idx], axis=-1),
                        tile_lo, tile_hi, table_lens, xp)


def next_population(pop, order_idx, d: GenDraws, tile_lo, tile_hi,
                    table_lens, n_elite: int, xp=np):
    """One serial-engine breeding step: elites survive, children are bred
    from rank-selected parents (crossover -> clip -> mutate).

    ``d`` must be one generation's draws (already ``gen_slice``\\ d).  This is
    THE host-side generation step — ``mapper._search_serial`` and the
    measured-objective kernel tuner (``kernel_bridge.tune_kernel``) both call
    it, so a modeled and a measured GA walking the same draw stream breed
    bit-identical genomes whenever their objectives rank populations the
    same way."""
    elites = pop[order_idx[:n_elite]]
    parents = pop[order_idx[d.ranks]]          # rank-based selection
    children = apply_crossover(parents, d, xp)
    children = clip_genomes(children, tile_lo, tile_hi, table_lens, xp)
    children = apply_mutation(children, d, tile_lo, tile_hi, table_lens, xp)
    return xp.concatenate([elites, children], axis=0)


def single_generation_draws(rng: np.random.Generator, space, cfg,
                            n: int) -> GenDraws:
    """One generation of draws for ``n`` genomes (standalone operator
    use); same stream layout as draw_run."""
    return gen_slice(draw_run(rng, space, cfg, 1, n), 0)


def initial_population(rng: np.random.Generator, space, cfg) -> np.ndarray:
    """Sample the starting population and seed slot 0 with the accelerator's
    baseline fixed mapping (clipped to the layer) so the InFlex design point
    is always present — both engines start from this exact population."""
    pop = space.sample(rng, cfg.population)
    base = space.clip(np.concatenate([
        np.minimum(np.asarray(space.spec.tile.fixed_tile, np.int32),
                   space.dims),
        [0, 0, 0, 0]])[None, :])
    pop[0] = base[0]
    return pop
