"""Analytical accelerator cost model (MAESTRO/Timeloop-style) on torch
tensors.  :func:`evaluate_mapping_impl` broadcasts over any leading batch
dims, so a whole GA population — or a whole (rows, population) engine
generation — evaluates in one pass of batched tensor ops on the device.

Hierarchy modelled (paper Fig 1/Fig 4): DRAM -> L2 global buffer -> PE array.
A *mapping* is (T, O, P, S):

  T : L2 tile sizes (t_K, t_C, t_Y, t_X, t_R, t_S)
  O : permutation of the 6 loops (outermost first) for the DRAM->L2 loops,
      reused intra-tile for PE-level stationarity
  P : ordered pair of dims spatially mapped to (rows, cols)
  S : logical array shape (rows, cols), rows*cols <= num_PEs

Loop-nest reuse analysis: a tensor with dependency set D must be re-fetched
once per iteration of every loop at or outside its innermost dependent loop;
loops strictly inside give free temporal reuse (the "stationary" window).

Runtime = max(compute, DRAM, L2) cycles (double-buffered) + tile-switch
stalls (systolic refill, paper Fig 3a).  Energy = per-access energies times
traffic at each level plus MAC energy.

Everything is float32, as in the JAX package, whose numbers are those of
the program XLA compiles from its graph, not of the graph as written.  The
port reproduces that program, which keeps it bit-identical to the
reference:

  * every 6-entry product is the explicit chain :func:`_prod6`, in the
    order XLA reduces (past 2**24 a float32 product depends on order);
  * the multiply-adds XLA fuses (DRAM traffic, runtime + stalls, the
    unscaled energy sum) are rounded once, through :func:`_fma`;
  * XLA's algebraic rewrites are applied by hand: ``(a / b) / c`` as
    ``a / (b * c)`` in the unscaled utilization, and ``3 * e_l1`` folded
    into one float32 constant;
  * with ``repr_bits=None`` (R pinned to the native width) no width-scale
    multiply is issued at all, the same program the reference traces.

Reordering or fusing these ops (``torch.compile``, an in-place rewrite)
changes results in the last bits and breaks the engines' parity.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..device import device_program
from .precision import element_scale, mac_scale, native_bits
from .spec import HWConfig
from .workloads import C, K, NUM_DIMS, R, S, X, Y

BIG = 1e30

# Dependency masks over (K, C, Y, X, R, S); depthwise swaps K-dependence for C.
_DEP_IN = (0, 1, 1, 1, 1, 1)       # input
_DEP_W = (1, 1, 0, 0, 1, 1)        # weight
_DEP_O = (1, 0, 1, 1, 0, 0)        # output
_DEP_W_DW = (0, 1, 0, 0, 1, 1)     # depthwise weight
_DEP_O_DW = (0, 1, 1, 1, 0, 0)     # depthwise output


@functools.lru_cache(maxsize=None)
def _mask_on(mask: tuple, device: torch.device) -> torch.Tensor:
    """A dependency mask as a bool tensor on ``device``, uploaded once per
    device: a pageable upload inside the GA's generation loop would make
    the host wait for the device's whole queue every generation."""
    return torch.tensor(mask, dtype=torch.bool, device=device)


class CostResult(NamedTuple):
    runtime: torch.Tensor       # cycles
    energy: torch.Tensor        # relative pJ (MAC = 1)
    feasible: torch.Tensor      # bool
    util: torch.Tensor          # average PE utilization in [0, 1]
    dram_elems: torch.Tensor    # total DRAM traffic (elements)
    l2_elems: torch.Tensor      # total L2 traffic (elements)
    edp: torch.Tensor           # energy-delay product


def _ceil_div(a, b):
    # floor division on float32 tensors, as ``//`` is in the reference
    return torch.floor_divide(a + b - 1.0, b)


def _fma(a, b, c):
    """float32 ``a * b + c`` rounded once, where XLA's CPU backend emits a
    fused multiply-add: the product is exact in float64, so one float64
    add and the cast back give the fused result (a double rounding differs
    only when the float64 sum lands exactly on a float32 halfway point)."""
    if isinstance(b, float):
        b = float(np.float32(b))          # the float32 constant XLA uses
    return (torch.as_tensor(a).double() * b + torch.as_tensor(c).double()
            ).float()


def _prod6(v: torch.Tensor) -> torch.Tensor:
    """Product over the last axis (length 6), one multiply at a time in
    the order XLA's CPU reduction takes."""
    return (((((v[..., 0] * v[..., 1]) * v[..., 2]) * v[..., 3])
             * v[..., 4]) * v[..., 5])


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` per batch element (broadcasting both)."""
    shape = torch.broadcast_shapes(x.shape[:-1], idx.shape[:-1])
    return torch.gather(x.expand(shape + x.shape[-1:]), -1,
                        idx.long().expand(shape + idx.shape[-1:]))


def _last_relevant(dep_in_order: torch.Tensor,
                   vals_in_order: torch.Tensor) -> torch.Tensor:
    """Innermost loop position whose dim is relevant AND iterates (> 1),
    or -1; shape ``(..., 1)``."""
    pos = torch.arange(NUM_DIMS, device=vals_in_order.device)
    relevant = dep_in_order & (vals_in_order > 1)
    return torch.where(relevant, pos, -1).amax(-1, keepdim=True)


def _reuse_multiplier(order, trips, dep):
    """prod of trip counts of loops at-or-outside the innermost dependent
    loop.  order: (..., 6) dim per position (0 = outermost); trips: (..., 6)
    per-dim trip count; dep: (..., 6) per-dim bool dependency."""
    trips_in_order = _take(trips, order)
    p_last = _last_relevant(_take(dep, order), trips_in_order)
    pos = torch.arange(NUM_DIMS, device=trips.device)
    mult = _prod6(torch.where(pos <= p_last, trips_in_order, 1.0))
    return torch.clamp(mult, min=1.0)


def _stationary_reuse(order, tile, dep, cap: float = 64.0):
    """Temporal reuse of a tensor inside the PE (L1) = product of tile sizes
    of loops strictly inside its innermost dependent loop, capped by
    register capacity.  This is what the O axis buys at the L2 level."""
    tile_in_order = _take(tile, order)
    p_last = _last_relevant(_take(dep, order), tile_in_order)
    pos = torch.arange(NUM_DIMS, device=tile.device)
    reuse = _prod6(torch.where(pos > p_last, tile_in_order, 1.0))
    return torch.clamp(reuse, 1.0, cap)


def _dep(mask: tuple, dw_mask: tuple, depthwise: torch.Tensor):
    dev = depthwise.device
    return torch.where(depthwise[..., None], _mask_on(dw_mask, dev),
                       _mask_on(mask, dev))


def evaluate_mapping_impl(dims, stride, depthwise, tiles, order, par,
                          shape_rc, hw: HWConfig, hard_partition,
                          repr_bits=None) -> CostResult:
    """Cost mappings of layers.  All tensors broadcast over leading dims.

    dims: (..., 6) int   layer (K, C, Y, X, R, S)
    stride: (...) int    conv stride
    depthwise: (...) bool
    tiles: (..., 6) int  L2 tile sizes (clipped to dims)
    order: (..., 6) int  permutation, outermost first
    par:   (..., 2) int  dims mapped to (rows, cols)
    shape_rc: (..., 2) int  (rows, cols)
    hard_partition: bool, or a (...) bool tensor (one flag per row in the
        batched engine).
    repr_bits: (...) int operand bit-width (R axis), or None for the native
        width.  Buffer occupancy, DRAM/L2 traffic/bandwidth, access energies
        and compute throughput all scale linearly with bits/native; MAC
        energy quadratically.  With None no scale multiply is issued.
    """
    f32 = torch.float32
    dev = tiles.device
    if repr_bits is None:
        bscale = mscale = None
    else:
        nb = float(native_bits(hw))
        rb = repr_bits.to(f32)
        bscale = element_scale(rb, nb)
        mscale = mac_scale(rb, nb)

    def scaled(v, s):
        return v if s is None else v * s

    depthwise = torch.as_tensor(depthwise, device=dev)
    dims = dims.to(f32)
    t = torch.minimum(torch.clamp(tiles.to(f32), min=1.0), dims)
    rows = shape_rc[..., 0].to(f32)
    cols = shape_rc[..., 1].to(f32)
    stride = stride.to(f32)

    dep_w = _dep(_DEP_W, _DEP_W_DW, depthwise)
    dep_o = _dep(_DEP_O, _DEP_O_DW, depthwise)
    dep_i = _mask_on(_DEP_IN, dev)

    # ---- tile volumes (elements) ------------------------------------------
    in_y = (t[..., Y] - 1.0) * stride + t[..., R]
    in_x = (t[..., X] - 1.0) * stride + t[..., S]
    vol_in = t[..., C] * in_y * in_x
    vol_w = torch.where(depthwise, 1.0, t[..., K]) * t[..., C] \
        * t[..., R] * t[..., S]
    vol_out = torch.where(depthwise, t[..., C], t[..., K]) \
        * t[..., Y] * t[..., X]

    # device-side fills, not uploads: nothing here makes the host wait
    buf = torch.full((), float(hw.buffer_elems), dtype=f32, device=dev)
    cap = buf / 3.0
    fits_part = (scaled(vol_in, bscale) <= cap) \
        & (scaled(vol_w, bscale) <= cap) & (scaled(vol_out, bscale) <= cap)
    fits_shared = scaled(vol_in + vol_w + vol_out, bscale) <= buf
    if not isinstance(hard_partition, torch.Tensor):
        hard_partition = torch.full((), bool(hard_partition),  # repro: disable=REP009 -- host value: the isinstance split above leaves only a Python bool here
                                    dtype=torch.bool, device=dev)
    fits = torch.where(hard_partition.to(dev), fits_part, fits_shared)

    # parallel dims must be distinct and the array must exist
    par_ok = (par[..., 0] != par[..., 1]) & (rows >= 1) & (cols >= 1) \
        & (rows * cols <= hw.num_pes)
    feasible = fits & par_ok

    # ---- trip counts & compute --------------------------------------------
    trips = _ceil_div(dims, t)                      # (..., 6) DRAM loops
    num_tiles = _prod6(trips)
    tile_macs = _prod6(t) / torch.where(depthwise, t[..., K], 1.0)
    total_macs = num_tiles * tile_macs              # padded (folded) MACs

    tp1 = _take(t, par[..., 0:1])[..., 0]
    tp2 = _take(t, par[..., 1:2])[..., 0]
    folds = _ceil_div(tp1, rows) * _ceil_div(tp2, cols)
    serial_iters = folds * tile_macs / (tp1 * tp2)  # cycles per tile
    # throughput scales with operand width (subword SIMD / bit-serial)
    compute_cycles = scaled(num_tiles * serial_iters, bscale)
    # average utilization incl. folding remainder; with no width scale XLA
    # folds (a / b) / c into a / (b * c), and so does the port
    if bscale is None:
        util = (num_tiles * tile_macs) / (
            (rows * cols) * torch.clamp(compute_cycles, min=1.0))
    else:
        ideal_cycles = num_tiles * tile_macs / (rows * cols) * bscale
        util = ideal_cycles / torch.clamp(compute_cycles, min=1.0)

    # ---- DRAM traffic via loop-nest reuse ---------------------------------
    out_mult = _reuse_multiplier(order, trips, dep_o)
    distinct_out = _prod6(torch.where(dep_o, trips, 1.0))
    psum_revisits = torch.clamp(out_mult - distinct_out, min=0.0)
    # dram_in + dram_w + dram_out, with the two products XLA fuses
    dram_w = vol_w * _reuse_multiplier(order, trips, dep_w)
    dram_elems = _fma(vol_out, distinct_out + 2.0 * psum_revisits,
                      _fma(vol_in, _reuse_multiplier(order, trips, dep_i),
                           dram_w))
    dram_cycles = scaled(dram_elems, bscale) / hw.dram_bw

    # ---- L2 traffic: spatial multicast + PE-level stationarity ------------
    def mcast(dep):
        d1 = _take(dep, par[..., 0:1])[..., 0]
        d2 = _take(dep, par[..., 1:2])[..., 0]
        f1 = torch.where(d1, 1.0, torch.minimum(tp1, rows))
        f2 = torch.where(d2, 1.0, torch.minimum(tp2, cols))
        return f1 * f2

    l2_in = total_macs / (mcast(dep_i) * _stationary_reuse(order, t, dep_i))
    l2_w = total_macs / (mcast(dep_w) * _stationary_reuse(order, t, dep_w))
    l2_out = total_macs / (mcast(dep_o) * _stationary_reuse(order, t, dep_o))
    l2_elems = l2_in + l2_w + l2_out
    l2_cycles = scaled(l2_elems, bscale) / hw.l2_bw

    # ---- stalls: stationary-tile switch == systolic refill (Fig 3a) -------
    # runtime = max(...) + stalls, the stall product fused as in XLA
    runtime = _fma(num_tiles - 1.0,
                   torch.minimum(tp1, rows) + torch.minimum(tp2, cols),
                   torch.maximum(torch.maximum(compute_cycles, dram_cycles),
                                 l2_cycles))
    runtime = torch.where(feasible, runtime, BIG)

    # ---- energy ------------------------------------------------------------
    # access energies scale linearly with width, MAC energy quadratically.
    # L1 accesses are 3 * total_macs; XLA folds 3 * e_l1 into one float32
    # constant and, unscaled, fuses the sum into a chain of FMAs.
    e_l1x3 = float(np.float32(3.0) * np.float32(hw.e_l1))
    if bscale is None:
        energy = _fma(total_macs, hw.e_mac,
                      _fma(total_macs, e_l1x3,
                           _fma(dram_elems, hw.e_dram,
                                l2_elems * hw.e_l2)))
    else:
        energy = (dram_elems * hw.e_dram * bscale
                  + l2_elems * hw.e_l2 * bscale
                  + total_macs * e_l1x3 * bscale
                  + total_macs * hw.e_mac * mscale)
    energy = torch.where(feasible, energy, BIG)

    return CostResult(
        runtime=runtime, energy=energy, feasible=feasible,
        util=torch.where(feasible, util, 0.0),
        dram_elems=dram_elems, l2_elems=l2_elems,
        edp=torch.where(feasible, runtime * energy, BIG),
    )


@device_program("hw", "hard_partition")
def evaluate_mapping(dims, stride, depthwise, tiles, order, par, shape_rc,
                     hw: HWConfig, hard_partition: bool = False,
                     repr_bits=None) -> CostResult:
    """Single-mapping entry point (0-d results)."""
    return evaluate_mapping_impl(dims, stride, depthwise, tiles, order, par,
                                 shape_rc, hw, hard_partition, repr_bits)


@device_program("hw", "hard_partition")
def evaluate_population(dims, stride, depthwise, tiles, order, par,
                        shape_rc, hw: HWConfig, hard_partition: bool = False,
                        reprs=None) -> CostResult:
    """One layer, a ``(P, ...)`` population of mappings (the layer's
    tensors broadcast over the population axis)."""
    return evaluate_mapping_impl(dims, stride, depthwise, tiles, order, par,
                                 shape_rc, hw, hard_partition, reprs)


@device_program("hw")
def evaluate_rows(dims, stride, depthwise, tiles, order, par, shape_rc,
                  hard_partition, hw: HWConfig, reprs=None) -> CostResult:
    """One mapping per *row*, where a row is a (layer, spec) pair: every
    tensor carries a leading ``(L,)`` axis, including the per-row
    hard-partition flag (and, when given, the per-row bit-width)."""
    return evaluate_mapping_impl(dims, stride, depthwise, tiles, order, par,
                                 shape_rc, hw, hard_partition, reprs)


def lower_bound_cycles(dims: np.ndarray, depthwise: bool,
                       hw: HWConfig) -> float:
    """Roofline lower bound: max(compute at full PE util, min DRAM traffic)."""
    k, c, y, x, r, s = [float(v) for v in dims]
    macs = (c if depthwise else k * c) * y * x * r * s
    in_elems = c * y * x          # >= one read of each input element
    w_elems = (1 if depthwise else k) * c * r * s
    o_elems = (c if depthwise else k) * y * x
    return max(macs / hw.num_pes, (in_elems + w_elems + o_elems) / hw.dram_bw)
