"""Operand-precision helper: the ONE place that knows how bit-widths scale
storage, bandwidth, energy and area.

The paper fixes arithmetic at 8-bit; the fifth (R, representation) axis
promotes the operand bit-width to a mapping choice.  Every layer of the
stack that used to hard-code a width routes through here:

  * ``HWConfig.bytes_per_elem`` is the InFlex *default* (native) width —
    ``native_bits(hw)`` derives it;
  * the cost model scales buffer occupancy, DRAM/L2 traffic/bandwidth and
    access energy linearly with ``bits / native`` (``element_scale``) and
    MAC energy quadratically (``mac_scale`` — array multipliers grow
    ~quadratically with operand width);
  * the area model sizes MACs with the same quadratic law
    (``mac_scale(bits, 8)`` relative to the calibrated 8-bit MAC_AREA);
  * ``tops_bridge`` derives its BF16 byte width from ``BF16_BITS``.

All scale functions are backend-agnostic: they accept python ints, numpy
arrays, or torch tensors (plain ``/`` and ``*`` only).  At the native
width the scale is *exactly* 1.0 (an IEEE-exact multiply/divide identity),
which is what keeps the R-pinned 10-gene engine bit-identical to the v4
9-gene golden metrics.
"""
from __future__ import annotations

# FullFlex R-axis domain: the supported operand widths of a fully
# representation-flexible datapath (bit-serial / subword recombination).
FULL_BITS = (2, 4, 8, 16, 32)

# PartFlex default menu: the common quantized-inference widths.
PART_BITS = (4, 8, 16)

BF16_BITS = 16


def native_bits(hw) -> int:
    """The HW's native operand width in bits (the InFlex-R default)."""
    return 8 * hw.bytes_per_elem


def bytes_of(bits):
    """Bit-width -> bytes (float: sub-byte widths pack fractionally)."""
    return bits / 8.0


def element_scale(bits, native_bits):
    """Linear storage/bandwidth/access-energy scale vs the native width.

    Backend-agnostic (python / numpy / torch).  Exactly 1.0 at the
    native width.
    """
    return bits / native_bits


def mac_scale(bits, native_bits):
    """Quadratic MAC energy/area scale vs the native width (multiplier
    area/energy grow ~quadratically with operand width)."""
    s = bits / native_bits
    return s * s
