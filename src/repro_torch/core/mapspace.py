"""Map-space machinery: Mapping container, per-axis spaces, legality, counting.

Implements the paper's Table 1 objects:

  W_X^w : workload map space (all T/O/P/S combos legal for the layer alone)
  C_X   : class map space (all combos legal under the HW *resources*)
  A_X   : target-accelerator map space (C_X + the accelerator's added
          constraints, e.g. hard-partitioned buffers, order subsets, ...)

Tile spaces are astronomically large (the paper quotes O(10^24) full map
spaces), so exact enumeration is used only for the O/P/S axes (720 / 30 /
|shape table| points); the T axis is counted exactly per-dim and intersected
with buffer constraints by Monte-Carlo estimation in flexion.py.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np

from .ga_ops import clip_genomes
from .spec import FULLFLEX, FlexSpec, HWConfig, INFLEX, ShapeSpec
from .workloads import Layer, NUM_DIMS


# Table construction is pure in the (frozen, hashable) axis specs, and the
# FullFlex order table alone is 720 rows — cache per spec rather than per
# MapSpace instance (a batched model search builds one MapSpace per layer).
@lru_cache(maxsize=512)
def _order_table(order_spec) -> np.ndarray:
    return order_spec.order_table()


@lru_cache(maxsize=512)
def _pair_table(parallel_spec) -> np.ndarray:
    return parallel_spec.pair_table()


@lru_cache(maxsize=512)
def _shape_table(shape_spec, num_pes: int) -> np.ndarray:
    return shape_spec.shape_table(num_pes)


@lru_cache(maxsize=512)
def _repr_table(repr_spec, default_bits: int) -> np.ndarray:
    return repr_spec.bits_table(default_bits)


@dataclasses.dataclass(frozen=True)
class Mapping:
    """A single design point: precise values for T, O, P, S, R (paper Sec 4.1
    plus this repo's fifth representation axis)."""

    tiles: Tuple[int, ...]              # 6 tile sizes (K, C, Y, X, R, S)
    order: Tuple[int, ...]              # permutation, outermost first
    parallel: Tuple[int, int]           # dims on (rows, cols)
    shape: Tuple[int, int]              # (rows, cols)
    repr_bits: int = 8                  # operand bit-width (R axis)

    def as_genome(self, spec: "MapSpace") -> np.ndarray:
        return spec.encode(self)


class MapSpace:
    """The feasible map space A_X^w of one accelerator on one layer.

    Mappings are encoded as fixed-length integer genomes for the GA mapper:

      genome[0:6]  tile sizes (raw ints, legality via cost-model penalty)
      genome[6]    index into the order table
      genome[7]    index into the parallel-pair table
      genome[8]    index into the shape table
      genome[9]    index into the representation (bit-width) table
    """

    GENOME_LEN = 10

    def __init__(self, layer: Layer, spec: FlexSpec):
        self.layer = layer
        self.spec = spec
        self.dims = np.asarray(layer.dims, dtype=np.int32)
        self.order_table = _order_table(spec.order)
        self.pair_table = _pair_table(spec.parallel)
        self.shape_table = _shape_table(spec.shape, spec.hw.num_pes)
        self.repr_table = _repr_table(spec.representation,
                                      8 * spec.hw.bytes_per_elem)
        if spec.tile.flex == INFLEX:
            fixed = np.minimum(np.asarray(spec.tile.fixed_tile, np.int32),
                               self.dims)
            self.tile_lo = fixed.copy()
            self.tile_hi = fixed.copy()
        else:
            self.tile_lo = np.ones(NUM_DIMS, np.int32)
            self.tile_hi = self.dims.copy()
        self.hard_partition = spec.tile.flex == "part"

    # -- encode / decode ----------------------------------------------------
    def encode(self, m: Mapping) -> np.ndarray:
        g = np.zeros(self.GENOME_LEN, np.int32)
        g[0:6] = m.tiles
        g[6] = _row_index(self.order_table, np.asarray(m.order, np.int32))
        g[7] = _row_index(self.pair_table, np.asarray(m.parallel, np.int32))
        g[8] = _row_index(self.shape_table, np.asarray(m.shape, np.int32))
        g[9] = _row_index(self.repr_table[:, None],
                          np.asarray([m.repr_bits], np.int32))
        return g

    def decode(self, genome: np.ndarray) -> Mapping:
        g = np.asarray(genome)
        return Mapping(
            tiles=tuple(int(v) for v in g[0:6]),
            order=tuple(int(v) for v in self.order_table[int(g[6])]),
            parallel=tuple(int(v) for v in self.pair_table[int(g[7])]),
            shape=tuple(int(v) for v in self.shape_table[int(g[8])]),
            repr_bits=int(self.repr_table[int(g[9])]),
        )

    # -- random sampling (respects per-axis flexibility) ---------------------
    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Uniform legal genomes via one bulk uniform draw (the batched
        engine samples one population per row, so this is a hot path).

        The R gene is drawn in a SEPARATE call made only when the R table is
        open — a pinned-R space consumes the byte-identical Generator stream
        of the v4 9-gene sampler (golden-parity discipline; see ga_ops)."""
        lo = np.concatenate([self.tile_lo, np.zeros(3, np.int64)])
        lens = self.table_lens().astype(np.int64)
        span = np.concatenate([(self.tile_hi - self.tile_lo + 1).astype(
            np.int64), lens[:3]])
        u = rng.random((n, 9))
        if lens[3] > 1:
            u_r = rng.random((n, 1))
        else:
            u_r = np.zeros((n, 1))
        legacy = (lo + u * span).astype(np.int32)
        r = (u_r * lens[3]).astype(np.int32)
        return np.concatenate([legacy, r], axis=-1)

    def table_lens(self) -> np.ndarray:
        """(4,) true lengths of the order / pair / shape / repr tables."""
        return np.asarray([len(self.order_table), len(self.pair_table),
                           len(self.shape_table), len(self.repr_table)],
                          np.int32)

    def clip(self, genomes: np.ndarray) -> np.ndarray:
        """Project genomes back into the legal (axis-constrained) space.
        Accepts any leading batch shape ``(..., 10)``; legacy 9-gene T/O/P/S
        genomes are zero-padded (gene 9 = 0, the first — for pinned specs the
        only — repr-table entry)."""
        g = np.asarray(genomes)
        if g.shape[-1] == self.GENOME_LEN - 1:
            g = np.concatenate(
                [g, np.zeros(g.shape[:-1] + (1,), g.dtype)], axis=-1)
        return clip_genomes(g, self.tile_lo, self.tile_hi,
                            self.table_lens(), np)

    # -- decoded arrays for the vectorized cost model ------------------------
    def decode_batch(self, genomes: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, np.ndarray]:
        """Decode genomes of any leading shape ``(..., 10)`` into the arrays
        the cost model consumes: tiles ``(..., 6)``, orders ``(..., 6)``,
        pairs ``(..., 2)``, shapes ``(..., 2)``, repr bits ``(...,)``."""
        g = np.asarray(genomes)
        tiles = g[..., 0:6].astype(np.int32)
        orders = self.order_table[np.mod(g[..., 6], len(self.order_table))]
        pairs = self.pair_table[np.mod(g[..., 7], len(self.pair_table))]
        shapes = self.shape_table[np.mod(g[..., 8], len(self.shape_table))]
        reprs = self.repr_table[np.mod(g[..., 9], len(self.repr_table))]
        return tiles, orders, pairs, shapes, reprs

    # -- axis-space cardinalities (exact where tractable) ---------------------
    def axis_cardinalities(self) -> dict:
        tile_card = int(np.prod((self.tile_hi - self.tile_lo + 1)
                                .astype(np.float64)))
        return {
            "T": tile_card,
            "O": len(self.order_table),
            "P": len(self.pair_table),
            "S": len(self.shape_table),
            "R": len(self.repr_table),
        }

    def size_upper_bound(self) -> float:
        c = self.axis_cardinalities()
        return float(c["T"]) * c["O"] * c["P"] * c["S"] * c["R"]


@lru_cache(maxsize=4096)
def mapspace_for(layer: Layer, spec: FlexSpec) -> MapSpace:
    """Cached MapSpace factory for the hot DSE paths (layers and specs are
    frozen/hashable; a Fig-13-style sweep rebuilds the same spaces hundreds
    of times otherwise)."""
    return MapSpace(layer, spec)


class PaddedTables(NamedTuple):
    """One spec's O/P/S/R index tables padded to the class-wide C_X maxima.

    Padding rows (zeros) are never read: the engines index tables modulo the
    *true* lengths in ``lens``.  Because the padded shapes depend only on
    ``hw`` (720 orders, 30 pairs, |FullFlex shape table| shapes, R_PAD
    widths), every spec sharing an HWConfig produces identically-shaped
    arrays — the batched engine can therefore stack the tables of any
    specs sharing an HWConfig into one tensor.
    """

    orders: np.ndarray   # (720, 6) i32
    pairs: np.ndarray    # (30, 2) i32
    shapes: np.ndarray   # (S_max(hw), 2) i32
    reprs: np.ndarray    # (R_PAD,) i32 operand bit-widths
    lens: np.ndarray     # (4,) i32 true table lengths


# R-table padding width: covers FULL_BITS (5 entries) with slack for custom
# PartFlex menus, while staying a fixed compile-time shape.
R_PAD = 8


@lru_cache(maxsize=64)
def _num_fullflex_shapes(num_pes: int) -> int:
    return len(ShapeSpec(flex=FULLFLEX).shape_table(num_pes))


def _pad_rows(table: np.ndarray, rows: int) -> np.ndarray:
    out = np.zeros((rows, table.shape[1]), np.int32)
    out[: len(table)] = table
    return out


@lru_cache(maxsize=512)
def padded_tables(spec: FlexSpec) -> PaddedTables:
    orders = _order_table(spec.order)
    pairs = _pair_table(spec.parallel)
    shapes = _shape_table(spec.shape, spec.hw.num_pes)
    reprs = _repr_table(spec.representation, 8 * spec.hw.bytes_per_elem)
    assert len(reprs) <= R_PAD, "representation menu exceeds R_PAD"
    lens = np.asarray([len(orders), len(pairs), len(shapes), len(reprs)],
                      np.int32)
    reprs_pad = np.zeros(R_PAD, np.int32)
    reprs_pad[: len(reprs)] = reprs
    return PaddedTables(
        orders=_pad_rows(orders, 720),
        pairs=_pad_rows(pairs, 30),
        shapes=_pad_rows(shapes, _num_fullflex_shapes(spec.hw.num_pes)),
        reprs=reprs_pad,
        lens=lens,
    )


def _row_index(table: np.ndarray, row: np.ndarray) -> int:
    hits = np.where((table == row[None, :]).all(axis=1))[0]
    if len(hits) == 0:
        raise ValueError(f"row {row} not in table (axis not that flexible)")
    return int(hits[0])


def workload_space_size(layer: Layer, hw: Optional[HWConfig] = None) -> float:
    """|W_X^w|: every tile size 1..dim, every order, every parallel pair,
    every array shape up to num_pes (workload space is HW-agnostic for T/O/P;
    S is bounded by an arbitrary max array size — we use the HW's)."""
    hw = hw or HWConfig()
    dims = np.asarray(layer.dims, dtype=np.float64)
    n_shapes = len(
        FlexSpec().shape.shape_table(hw.num_pes))
    return float(np.prod(dims)) * 720.0 * 30.0 * n_shapes
