"""Area/power cost model of flexibility hardware (paper Fig 4 + Table 3).

The paper synthesized RTL of each flexibility feature (Nangate 15nm, SAED32
SRAM scaled).  We reproduce the *structure* of that cost model: a base
inflexible accelerator (MACs + buffers + NoC) plus per-axis adders:

  T: base/bound/current registers per operand + soft-partition (de)muxes
  O: extra address counters/generators + per-PE count-up register
  P: 3 address counters/generators + per-PE reduction-path mux
  S: multicast-capable distribution NoC + per-PE output demux + reduction NoC
  R: per-PE subword gating/recombination muxes + a width-select config
     register (the MAC array itself is sized for the *native* width; wider
     operands run bit-serially, which the cost model charges in cycles, not
     area — so R-flex stays within the paper's <2% overhead envelope)

Constants are calibrated so the relative overheads reproduce Table 3
(InFlex 736,843 um^2; FullFlex +0.37%; T +0.004%... the paper's Table 3
column header pairs InFlex area with a 50,045 um^2 buffer block).  Absolute
um^2 are 15nm-equivalent and, like the paper's, dominated by MACs + SRAM.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .precision import mac_scale, native_bits
from .spec import FlexSpec, HWConfig, INFLEX

# 15nm-equivalent component areas (um^2). Calibrated against Table 3 at the
# paper's 1024-PE / 100KB design point.
MAC_AREA = 559.0                 # per PE (incl. local regs)
SRAM_AREA_PER_KB = 500.45        # global buffer
NOC_AREA_PER_PE = 112.0          # baseline unicast distribution + collection
REG_AREA = 2.2                   # one 32-bit register
MUX_AREA_PER_CHOICE = 0.65       # per PE-side 2:1 mux equivalent
ADDR_GEN_AREA = 95.0             # one configurable address generator

# per-access energies (pJ, relative scale shared with cost_model)
MAC_POWER_UW = 38.0
SRAM_POWER_UW_PER_KB = 21.0
NOC_POWER_UW_PER_PE = 3.1


@dataclasses.dataclass(frozen=True)
class AreaReport:
    base_area: float
    overhead: Dict[str, float]       # per-axis added area (um^2)
    total_area: float
    base_power: float
    total_power: float

    @property
    def overhead_pct(self) -> float:
        return 100.0 * (self.total_area - self.base_area) / self.base_area


def mac_array_area(hw: HWConfig) -> float:
    """MAC array area, precision-dependent: multiplier area scales
    quadratically with the native operand width (MAC_AREA is calibrated at
    8-bit, so the default HW scales by exactly 1.0)."""
    return hw.num_pes * MAC_AREA * mac_scale(native_bits(hw), 8)


def base_accelerator_area(hw: HWConfig) -> float:
    kb = hw.buffer_bytes / 1024.0
    return (mac_array_area(hw) + kb * SRAM_AREA_PER_KB
            + hw.num_pes * NOC_AREA_PER_PE)


def tile_flex_area(hw: HWConfig, soft_partition: bool) -> float:
    # base/bound/current registers for each of 3 operands
    regs = 3 * 3 * REG_AREA
    if soft_partition:
        # soft partition: mux/demux trees on the buffer banks (1 per 1KB bank)
        banks = hw.buffer_bytes / 1024.0
        regs += banks * 8 * MUX_AREA_PER_CHOICE * 3
    return regs


def order_flex_area(hw: HWConfig, n_orders: int) -> float:
    # 3 extra address counters + generators; per-PE count-up register
    # (16-bit), plus a log2(n)-bit order-select config register
    import math
    return 3 * (REG_AREA + ADDR_GEN_AREA) + hw.num_pes * REG_AREA * 0.5 \
        + math.log2(max(n_orders, 2)) * REG_AREA


def parallel_flex_area(hw: HWConfig, n_pairs: int) -> float:
    # 3 address counters/generators + per-PE spatial/temporal reduction mux
    import math
    return 3 * (REG_AREA + ADDR_GEN_AREA) \
        + hw.num_pes * MUX_AREA_PER_CHOICE \
        + math.log2(max(n_pairs, 2)) * REG_AREA


def repr_flex_area(hw: HWConfig, n_bits_options: int) -> float:
    # per-PE subword gating/recombination mux (one 2:1-equivalent per
    # selectable width step) + a log2(n)-bit width-select config register;
    # NOT a wider multiplier — sub-native widths gate the existing array and
    # super-native widths run bit-serially (charged in cycles by the cost
    # model), which keeps R the cheap axis the ISA-based prior work reports.
    import math
    sel = math.log2(max(n_bits_options, 2))
    return hw.num_pes * MUX_AREA_PER_CHOICE * sel + sel * REG_AREA


def shape_flex_area(hw: HWConfig, n_shapes: int) -> float:
    # multicast muxing on the row/column distribution spines + reduction NoC
    # forward/L2 demux per edge PE (paper Fig 4d) — NOT per-PE, which is why
    # Table 3 shows S as the cheapest axis.
    import math
    fanout = max(math.log2(max(n_shapes, 2)), 1.0)
    edges = 2.0 * math.sqrt(hw.num_pes)
    return edges * MUX_AREA_PER_CHOICE * fanout


def area_of(spec: FlexSpec) -> AreaReport:
    hw = spec.hw
    base = base_accelerator_area(hw)
    ov: Dict[str, float] = {"T": 0.0, "O": 0.0, "P": 0.0, "S": 0.0,
                            "R": 0.0}
    if spec.tile.flex != INFLEX:
        ov["T"] = tile_flex_area(hw, soft_partition=spec.tile.flex == "full")
    if spec.order.flex != INFLEX:
        ov["O"] = order_flex_area(hw, len(spec.order.order_table()))
    if spec.parallel.flex != INFLEX:
        ov["P"] = parallel_flex_area(hw, len(spec.parallel.pair_table()))
    if spec.shape.flex != INFLEX:
        ov["S"] = shape_flex_area(hw, len(spec.shape.shape_table(hw.num_pes)))
    if spec.representation.flex != INFLEX:
        ov["R"] = repr_flex_area(
            hw, len(spec.representation.bits_table(native_bits(hw))))

    total = base + sum(ov.values())
    kb = hw.buffer_bytes / 1024.0
    base_power = (hw.num_pes * MAC_POWER_UW + kb * SRAM_POWER_UW_PER_KB
                  + hw.num_pes * NOC_POWER_UW_PER_PE)
    # flexibility features add proportional control power
    total_power = base_power * (total / base)
    return AreaReport(base_area=base, overhead=ov, total_area=total,
                      base_power=base_power, total_power=total_power)
