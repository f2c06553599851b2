"""FlexSpec — the "HW flexibility specification" input of the paper's Fig 6.

An accelerator is described by:
  * HW resources (PE count, buffer size, bandwidths) -> defines C_X,
  * a per-axis flexibility level (InFlex / PartFlex / FullFlex) with an
    axis-specific payload -> defines A_X ⊆ C_X.

The binary class vector of the paper's Eq. (1) is derived: an axis scores 1
iff it exposes >1 legal choice.  This repo extends the paper's four axes
(T/O/P/S) with a fifth representation axis R (operand bit-width), so the
class vector is [X_T, X_O, X_P, X_S, X_R]; ``HWConfig.bytes_per_elem`` is
the InFlex-R *default* width, not a global constant.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .precision import FULL_BITS, PART_BITS
from .workloads import DIMS, NUM_DIMS

INFLEX = "inflex"
PARTFLEX = "part"
FULLFLEX = "full"

# Canonical loop orders by stationary tensor (paper Sec 6.3):
#   output stationary = YXKCRS (InFlex-0100 baseline)
#   weight stationary = KCRSYX
#   input  stationary = CYXKRS
ORDER_OUTPUT_STATIONARY = "YXKCRS"
ORDER_WEIGHT_STATIONARY = "KCRSYX"
ORDER_INPUT_STATIONARY = "CYXKRS"
ORDER_NVDLA = "KCYXRS"  # Table 2 baseline


def order_str_to_perm(s: str) -> Tuple[int, ...]:
    assert sorted(s) == sorted(DIMS), f"bad order string {s!r}"
    return tuple(DIMS.index(ch) for ch in s)


def perm_to_order_str(p: Sequence[int]) -> str:
    return "".join(DIMS[i] for i in p)


ALL_ORDERS: Tuple[Tuple[int, ...], ...] = tuple(
    itertools.permutations(range(NUM_DIMS))
)
ALL_PAR_PAIRS: Tuple[Tuple[int, int], ...] = tuple(
    (a, b) for a in range(NUM_DIMS) for b in range(NUM_DIMS) if a != b
)  # 30 ordered pairs (paper Sec 6.4: C_X = 6x5 = 30)


@dataclasses.dataclass(frozen=True)
class HWConfig:
    """Baseline HW resources (paper Table 2)."""

    num_pes: int = 1024
    buffer_bytes: int = 100 * 1024       # 100KB on-chip global buffer
    bytes_per_elem: int = 1              # 8-bit operands
    dram_bw: float = 16.0                # elements / cycle
    l2_bw: float = 256.0                 # elements / cycle
    # Relative access energies (Eyeriss-style), MAC = 1.0:
    e_mac: float = 1.0
    e_l1: float = 1.6
    e_l2: float = 6.0
    e_dram: float = 200.0

    @property
    def buffer_elems(self) -> int:
        return self.buffer_bytes // self.bytes_per_elem


@dataclasses.dataclass(frozen=True)
class TileSpec:
    flex: str = FULLFLEX
    fixed_tile: Tuple[int, ...] = (64, 16, 3, 3, 3, 3)  # Table 2 baseline T
    # PartFlex-1000 = hard-partitioned buffer with this I:W:O ratio (paper 1:1:1)
    hard_partition: Tuple[float, float, float] = (1 / 3, 1 / 3, 1 / 3)

    @property
    def is_flexible(self) -> bool:
        return self.flex != INFLEX


@dataclasses.dataclass(frozen=True)
class OrderSpec:
    flex: str = FULLFLEX
    fixed_order: str = ORDER_NVDLA
    # PartFlex-0100 = a subset of orders (paper: output/input/weight stationary)
    allowed_orders: Tuple[str, ...] = (
        ORDER_OUTPUT_STATIONARY, ORDER_WEIGHT_STATIONARY, ORDER_INPUT_STATIONARY,
    )

    def order_table(self) -> np.ndarray:
        """(n_orders, 6) permutation table the mapper indexes into."""
        if self.flex == INFLEX:
            perms = [order_str_to_perm(self.fixed_order)]
        elif self.flex == PARTFLEX:
            perms = [order_str_to_perm(o) for o in self.allowed_orders]
        else:
            perms = list(ALL_ORDERS)
        return np.asarray(perms, dtype=np.int32)

    @property
    def is_flexible(self) -> bool:
        return self.flex != INFLEX


@dataclasses.dataclass(frozen=True)
class ParallelSpec:
    flex: str = FULLFLEX
    fixed_pair: Tuple[str, str] = ("K", "C")  # Table 2 baseline P
    # PartFlex-0010 = {K-C, Y-X} (paper Sec 6.4)
    allowed_pairs: Tuple[Tuple[str, str], ...] = (("K", "C"), ("Y", "X"))

    def pair_table(self) -> np.ndarray:
        def enc(p: Tuple[str, str]) -> Tuple[int, int]:
            return (DIMS.index(p[0]), DIMS.index(p[1]))

        if self.flex == INFLEX:
            pairs = [enc(self.fixed_pair)]
        elif self.flex == PARTFLEX:
            pairs = [enc(p) for p in self.allowed_pairs]
        else:
            pairs = list(ALL_PAR_PAIRS)
        return np.asarray(pairs, dtype=np.int32)

    @property
    def is_flexible(self) -> bool:
        return self.flex != INFLEX


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    flex: str = FULLFLEX
    fixed_shape: Tuple[int, int] = (16, 64)  # Table 2 baseline S
    # PartFlex-0001 = shapes composed from a building block (paper: A=16, B=4)
    building_block: int = 16

    def shape_table(self, num_pes: int) -> np.ndarray:
        """(n_shapes, 2) table of (rows, cols) with rows*cols <= num_pes."""
        if self.flex == INFLEX:
            shapes = [self.fixed_shape]
        elif self.flex == PARTFLEX:
            b = self.building_block
            shapes = []
            max_blocks = num_pes // (b * b)
            for a in range(1, max_blocks + 1):
                for c in range(1, max_blocks + 1):
                    if a * c <= max_blocks:
                        shapes.append((a * b, c * b))
        else:
            # FullFlex: any row count, widest legal column count (paper's
            # FullFlex-0001 picks e.g. 24x42 on 1024 PEs).
            shapes = []
            for r in range(1, num_pes + 1):
                c = num_pes // r
                if c >= 1:
                    shapes.append((r, c))
            shapes = sorted(set(shapes))
        return np.asarray(shapes, dtype=np.int32)

    @property
    def is_flexible(self) -> bool:
        return self.flex != INFLEX


@dataclasses.dataclass(frozen=True)
class RepresentationSpec:
    """Fifth axis (R): the operand bit-widths the datapath can execute.

    InFlex-R runs only the native width (``fixed_bits``, defaulting to the
    HW's ``bytes_per_elem``); PartFlex-R offers a small quantized-inference
    menu (``allowed_bits``); FullFlex-R covers :data:`precision.FULL_BITS`
    via bit-serial / subword recombination.
    """

    flex: str = INFLEX
    fixed_bits: Optional[int] = None     # None -> native (hw.bytes_per_elem*8)
    allowed_bits: Tuple[int, ...] = PART_BITS

    def bits_table(self, default_bits: int) -> np.ndarray:
        """(n_bits,) table of selectable operand widths."""
        if self.flex == INFLEX:
            bits = [self.fixed_bits or default_bits]
        elif self.flex == PARTFLEX:
            bits = sorted(set(self.allowed_bits))
        else:
            bits = sorted(set(FULL_BITS))
        return np.asarray(bits, dtype=np.int32)

    @property
    def is_flexible(self) -> bool:
        return self.flex != INFLEX


@dataclasses.dataclass(frozen=True)
class FlexSpec:
    """Full accelerator description = HW resources + per-axis flexibility."""

    name: str = "FullFlex1111"
    hw: HWConfig = dataclasses.field(default_factory=HWConfig)
    tile: TileSpec = dataclasses.field(default_factory=TileSpec)
    order: OrderSpec = dataclasses.field(default_factory=OrderSpec)
    parallel: ParallelSpec = dataclasses.field(default_factory=ParallelSpec)
    shape: ShapeSpec = dataclasses.field(default_factory=ShapeSpec)
    representation: RepresentationSpec = dataclasses.field(
        default_factory=RepresentationSpec)

    def class_vector(self) -> Tuple[int, int, int, int, int]:
        """[X_T, X_O, X_P, X_S, X_R] (paper Eq. (1) + the fifth axis)."""
        return (
            int(self.tile.is_flexible),
            int(self.order.is_flexible),
            int(self.parallel.is_flexible),
            int(self.shape.is_flexible),
            int(self.representation.is_flexible),
        )

    def class_id(self) -> int:
        t, o, p, s, r = self.class_vector()
        return (t << 4) | (o << 3) | (p << 2) | (s << 1) | r

    def class_str(self) -> str:
        return "".join(str(b) for b in self.class_vector())


# --------------------------------------------------------------------------
# Named accelerator variants used across the paper's evaluations
# --------------------------------------------------------------------------

def _axes(t: str, o: str, p: str, s: str, r: str, hw: HWConfig, name: str,
          **kw) -> FlexSpec:
    return FlexSpec(
        name=name, hw=hw,
        tile=TileSpec(flex=t, **{k: v for k, v in kw.items()
                                 if k in ("fixed_tile", "hard_partition")}),
        order=OrderSpec(flex=o, **{k: v for k, v in kw.items()
                                   if k in ("fixed_order", "allowed_orders")}),
        parallel=ParallelSpec(flex=p, **{k: v for k, v in kw.items()
                                         if k in ("fixed_pair", "allowed_pairs")}),
        shape=ShapeSpec(flex=s, **{k: v for k, v in kw.items()
                                   if k in ("fixed_shape", "building_block")}),
        representation=RepresentationSpec(
            flex=r, **{k: v for k, v in kw.items()
                       if k in ("fixed_bits", "allowed_bits")}),
    )


def make_variant(class_str: str, level: str = FULLFLEX,
                 hw: Optional[HWConfig] = None, **kw) -> FlexSpec:
    """Build e.g. make_variant('1000', 'part') == PartFlex-1000.

    Accepts 4-char (T/O/P/S, R pinned to the native width — the paper's
    taxonomy, keeping legacy variant names) or 5-char (T/O/P/S/R) class
    strings.
    """
    hw = hw or HWConfig()
    assert len(class_str) in (4, 5) and set(class_str) <= {"0", "1"}
    lv = [level if b == "1" else INFLEX for b in class_str.ljust(5, "0")]
    prefix = {INFLEX: "InFlex", PARTFLEX: "PartFlex", FULLFLEX: "FullFlex"}[level]
    return _axes(lv[0], lv[1], lv[2], lv[3], lv[4], hw,
                 name=f"{prefix}{class_str}", **kw)


def inflex_baseline(hw: Optional[HWConfig] = None) -> FlexSpec:
    """InFlex-0000 with the paper's Table 2 mapping config."""
    return make_variant("0000", hw=hw)
