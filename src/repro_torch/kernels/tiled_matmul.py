"""TOPS-configurable tiled matmul: the hand-written Hopper kernel
(``csrc/tiled_matmul.cu``) behind :func:`tiled_matmul`, and its plain
PyTorch version :func:`tiled_matmul_plain`.

The paper's flexibility axes, at the kernel level:

  T — block shape (bm, bn, bk): the shared-memory tile sizes.  Legality =
      blocks divide the dims and the tiles fit a block's shared memory
      (the analogue of "tiles fit the L2 buffer"), see :func:`smem_bytes`.
  O — stationarity order:
        'out' : one block per output tile, float32 accumulator over all K
        'a'   : x tile stationary, the block sweeps all column blocks
        'b'   : y tile stationary, the block sweeps all row blocks
      'a'/'b' add each K-block's partial into the output in its own dtype.

The wrapper takes the plain version for CPU tensors only; for a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import cast

ORDERS = ("out", "a", "b")
# Shared memory one block may use on an H100 (227 KB opt-in; CUDA C++
# Programming Guide, compute capability 9.0 technical specifications).
SMEM_LIMIT_BYTES = 232_448

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ORDER_CODE = {o: i for i, o in enumerate(ORDERS)}


def smem_bytes(bm: int, bn: int, bk: int, dtype_bytes: float = 2) -> float:
    """Dynamic shared memory one kernel block may request: the float32
    accumulator tile plus the x and y tiles at the operand width
    (``precision.bytes_of`` of the executed width).  A launch requests at
    most this many bytes (:func:`launch_plan`); the bridge's legality tests
    this formula."""
    return bm * bn * 4 + (bm * bk + bk * bn) * dtype_bytes


# The edges a thread's register micro-tile may take, largest first, and the
# most threads a float32 launch runs.
MICRO_EDGES = (8, 4, 2, 1)
MAX_THREADS = 256


class LaunchPlan(NamedTuple):
    """How one launch runs its (bm, bn, bk) tile; offsets and sizes in
    bytes of dynamic shared memory.

    float32: each thread owns ``tm`` x ``tn`` micro-tiles of the output in
    registers; the operand tiles arrive by ``cp.async``, 16 bytes a copy
    where the rows allow it.  When ``acc_in_regs`` is false (order "out"
    with more micro-tiles than threads) the float32 accumulator tile lives
    at offset 0 and the operands behind it.  bfloat16 and int8 launches
    take a :class:`MmaPlan` instead."""
    tm: int
    tn: int
    threads: int
    acc_in_regs: bool
    buffers: int                 # operand buffers: 2 = copy overlaps product
    smem: int                    # bytes requested, <= smem_bytes(...)
    x_vec: bool                  # x rows read 4 floats at a time
    x_ld: int                    # floats from one x row to the next
    x_copy16: bool               # x tile staged by 16-byte copies, else 4
    y_copy16: bool               # y tile staged by 16-byte copies, else 4
    ys_at: Tuple[int, ...]       # offset of the y tile in each buffer
    xs_at: Tuple[int, ...]       # offset of the x tile in each buffer


def _micro_edge(block: int) -> int:
    return next(e for e in MICRO_EDGES if block % e == 0)


def _place(regions, limit):
    """Offsets of ``(size, align)`` regions laid out in order, each start
    rounded up to its alignment, and the end; None past ``limit``."""
    at, offsets = 0, []
    for size, align in regions:
        at = -(-at // align) * align
        offsets.append(at)
        at += size
    return (offsets, at) if at <= limit else None


# Fragments (16 x 8 outputs each) a warp owns, down x across: the layouts
# the bfloat16/int8 kernel is built for; at most 8 warps a block (255
# registers a thread).  Orders "a"/"b" hold each fragment's previous output
# values beside its accumulator, so they stop at 2 x 4.
MMA_LAYOUTS = ((1, 1), (2, 2), (2, 4), (4, 4), (4, 8))
MMA_LAYOUTS_AB = MMA_LAYOUTS[:3]
MAX_MMA_WARPS = 8
MAX_STAGES = 4
# Warps of one fragment in orders "a"/"b" (the thin, latency-bound tiles)
# run GROUP steps of a sweep an iteration through a ring of 2 to 4
# iterations (GROUP_STAGES, the deepest that fits first), on up to
# MAX_GROUP_WARPS warps.
GROUP = 4
GROUP_STAGES = (16, 12, 8)
MAX_GROUP_WARPS = 16


class MmaPlan(NamedTuple):
    """How one bfloat16 or int8 launch runs its (bm, bn, bk) tile on the
    tensor cores; offsets and sizes in bytes of dynamic shared memory.

    Each warp owns ``frag_m`` x ``frag_n`` fragments of 16 x 8 outputs; a
    ``warps_m`` x ``warps_n`` grid of warps covers the tile in ``passes_m``
    x ``passes_n`` passes.  The accumulator stays in registers over all of
    K when one pass covers the tile (orders "a"/"b" keep each K-block's
    partial in registers anyway); otherwise the float32/int32 accumulator
    tile lives at offset 0.  The tiles that change every step (x and y in
    order "out", y in "a", x in "b") go through a ring of ``stages``
    buffers ``stage_bytes`` apart, staged ``stages - 1`` steps ahead; the
    stationary tile of "a" (x) or "b" (y) has one buffer of its own.  With
    ``group`` 4 (one fragment a warp, orders "a"/"b", sweeps a multiple of
    4 steps) each iteration runs 4 steps and stages 4 more, 1 to 3
    iterations ahead, and ``threads`` holds as many copies of the warp grid
    as fit in 16 warps, each copy taking its share of the 4 steps."""
    frag_m: int
    frag_n: int
    warps_m: int
    warps_n: int
    passes_m: int
    passes_n: int
    threads: int
    acc_in_regs: bool
    stages: int
    smem: int                    # bytes requested, <= smem_bytes(...)
    x_ld: int                    # elements from one staged x row to the next
    y_ld: int                    # elements from one staged y row to the next
    x_copy: int                  # bytes a cp.async copies; 0: via registers
    y_copy: int
    x_word: bool                 # staged x rows read 4 bytes at a time
    xs_at: int                   # x tile of stage 0 (or the stationary one)
    ys_at: int                   # y tile of stage 0 (or the stationary one)
    stage_bytes: int             # bytes from one ring stage to the next
    group: int                   # steps an iteration: 1 or GROUP


def _mma_layout(bm: int, bn: int, order: str):
    """(frag_m, frag_n, warps_m, warps_n, passes_m, passes_n): the layout
    of MMA_LAYOUTS (MMA_LAYOUTS_AB for orders "a"/"b") that covers the tile
    in the fewest passes, then with the most warps, then with the fewest
    fragments a warp."""
    fm_n, fn_n = -(-bm // 16), -(-bn // 8)
    best = None
    for fm, fn in MMA_LAYOUTS if order == "out" else MMA_LAYOUTS_AB:
        wm, wn = -(-fm_n // fm), -(-fn_n // fn)
        pm = pn = 1
        if wm * wn > MAX_MMA_WARPS:
            wn2 = min(wn, MAX_MMA_WARPS)
            wm2 = min(wm, MAX_MMA_WARPS // wn2)
            pm, pn = -(-wm // wm2), -(-wn // wn2)
            wm, wn = wm2, wn2
        key = (pm * pn, -wm * wn, fm * fn)
        if best is None or key < best[0]:
            best = (key, (fm, fn, wm, wn, pm, pn))
    return best[1]


def _padded(cols: int, item: int, rule) -> int:
    """The least row length >= cols whose bytes satisfy ``rule``."""
    ld = cols
    while not rule(ld * item):
        ld += 1
    return ld


def _copy_width(row_bytes: int, src_ptr: int, dst_ld_bytes: int,
                dst_offsets) -> int:
    """The widest cp.async (16, 8 or 4 bytes) every copy of the tile can
    take, 0 when rows or addresses allow none (staged through registers).
    A device row is a whole number of tile rows (blocks divide the dims),
    so its stride is as aligned as the tile row."""
    for w in (16, 8, 4):
        if (row_bytes % w == 0 and src_ptr % w == 0 and dst_ld_bytes % w == 0
                and all(o % w == 0 for o in dst_offsets)):
            return w
    return 0


def mma_plan(bm: int, bn: int, bk: int, dtype_bytes: int, order: str,
             x_ptr: int = 0, y_ptr: int = 0, m: int = 0,
             n: int = 0) -> MmaPlan:
    """The bfloat16 (``dtype_bytes`` 2) or int8 (1) launch of blocks
    ``(bm, bn, bk)``, given the operands' addresses and, for the steps of
    a sweep in orders "a"/"b", the dims M and N (0: unknown, one step an
    iteration).

    Staged rows are padded where the formula leaves room, so that a warp's
    fragment reads fall on distinct banks: x rows to 16 bytes past a
    multiple of 32 (lanes read 4 bytes at 8 rows x 4 columns), y rows to 16
    bytes past a multiple of 64 (bfloat16) or 32 (int8), where the tile has
    8 rows (x) or columns (y) to read at once.  The first layout
    that fits wins: padded rows with 4, 3 or 2 ring stages, unpadded rows
    with as many, then one stage padded or not; the last layout tried (one
    stage, no padding, regions packed at element alignment) always fits
    the formula.  Warps of one fragment in orders "a"/"b" whose sweeps are
    a multiple of GROUP steps try rings of GROUP_STAGES first, for
    ``group`` GROUP."""
    item = dtype_bytes
    formula = int(smem_bytes(bm, bn, bk, item))
    fm, fn, wm, wn, pm, pn = _mma_layout(bm, bn, order)
    acc_in_regs = order != "out" or pm * pn == 1
    y_rule = ((lambda b: b % 64 == 16) if item == 2
              else (lambda b: b % 32 == 16))
    # (a tile under 8 rows or columns is read by fewer lanes than a bank
    # cycle serves: no padding)
    pads = ((_padded(bk, item, lambda b: b % 32 == 16) if bm >= 8 else bk,
             _padded(bn, item, y_rule) if bn >= 8 else bn), (bk, bn))
    # bank-conflict-free reads first, then a deeper ring
    layouts = [(stages, x_ld, y_ld, 16) for above in (True, False)
               for x_ld, y_ld in pads for stages in range(MAX_STAGES, 0, -1)
               if (stages > 1) == above]
    layouts.append((1, bk, bn, item))
    sweep = (n // bn if order == "a" else m // bm) if m and n else 0
    if ((fm, fn) == (1, 1) and order != "out" and pm * pn == 1
            and sweep % GROUP == 0 and sweep > 0):
        layouts = [(stages, x_ld, y_ld, 16) for stages in GROUP_STAGES
                   for x_ld, y_ld in pads] + layouts
    group = 1
    for stages, x_ld, y_ld, align in layouts:
        xb, yb = bm * x_ld * item, bk * y_ld * item
        at = 0 if acc_in_regs else 4 * bm * bn
        up = lambda v: -(-v // align) * align    # noqa: E731
        if order == "out":
            xs = up(at)
            ys = up(xs + xb)
            stage = up(ys + yb - xs)
            end = xs + (stages - 1) * stage + ys + yb - xs
        else:
            st_bytes, mv_bytes = (xb, yb) if order == "a" else (yb, xb)
            st = up(at)
            mv = up(st + st_bytes)
            stage = up(mv_bytes)
            end = mv + (stages - 1) * stage + mv_bytes
            xs, ys = (st, mv) if order == "a" else (mv, st)
        if end <= formula:
            group = GROUP if stages in GROUP_STAGES else 1
            break
    x_ring = order != "a"
    y_ring = order != "b"
    x_offs = [xs + s * stage for s in range(stages if x_ring else 1)]
    y_offs = [ys + s * stage for s in range(stages if y_ring else 1)]
    # four steps an iteration run on as many copies of the warp grid as fit
    copies = min(GROUP, MAX_GROUP_WARPS // (wm * wn)) if group > 1 else 1
    return MmaPlan(
        fm, fn, wm, wn, pm, pn, 32 * wm * wn * copies, acc_in_regs, stages,
        end,
        x_ld, y_ld,
        _copy_width(bk * item, x_ptr, x_ld * item, x_offs),
        _copy_width(bn * item, y_ptr, y_ld * item, y_offs),
        (x_ld * item) % 4 == 0 and all(o % 4 == 0 for o in x_offs),
        xs, ys, stage, group)


def launch_plan(bm: int, bn: int, bk: int, dtype_bytes: int = 4,
                order: str = "out", x_ptr: int = 0, y_ptr: int = 0,
                m: int = 0, n: int = 0):
    """The launch of blocks ``(bm, bn, bk)`` at the operand width, given the
    operands' addresses (16-byte copies need them 16-byte aligned): a
    :class:`LaunchPlan` for float32, the :func:`mma_plan` of bfloat16 and
    int8 (which also takes the dims M and N).

    float32: the micro-tile edges are the largest of 8, 4, 2, 1 dividing
    bm and bn; threads cover the micro-tiles in whole warps, 32 to 256, and
    loop when there are more.  The accumulator stays in registers over all
    of K when each thread holds at most one micro-tile (orders "a"/"b" keep
    each K-block's partial in registers anyway); its 4*bm*bn bytes then
    hold a second operand buffer where one fits.

    Thread (uy, ux) owns rows uy, uy + bm/tm, ...: the threads of one
    shared-memory read phase (8 for 16-byte reads, 32 for 4-byte ones)
    then read neighbouring x rows, which fall on distinct banks when the
    row stride is odd in reads; x rows are padded to that where the
    formula leaves room."""
    formula = int(smem_bytes(bm, bn, bk, dtype_bytes))
    if dtype_bytes != 4:
        return mma_plan(bm, bn, bk, dtype_bytes, order, x_ptr, y_ptr, m, n)
    tm, tn = _micro_edge(bm), _micro_edge(bn)
    rows, cols = bm // tm, bn // tn
    threads = min(MAX_THREADS, max(32, -(-rows * cols // 32) * 32))
    acc_in_regs = order != "out" or rows * cols <= threads
    # y (and accumulator) rows are read tn floats at a time, up to 4
    row_align = 4 * min(tn, 4)
    head = [] if acc_in_regs else [(4 * bm * bn, row_align)]
    layouts = []
    for x_vec in ((True, False) if bk % 4 == 0 else (False,)):
        width, phase = (4, 8) if x_vec else (1, 32)
        pads = [0]
        if rows > 1 and cols < phase and (bk // width) % 2 == 0:
            pads.insert(0, width)
        for buffers in ((2, 1) if acc_in_regs else (1,)):
            layouts += [(x_vec, bk + pad, buffers) for pad in pads]
    for x_vec, x_ld, buffers in layouts:
        placed = _place(head + [(4 * bk * bn, row_align),
                                (4 * bm * x_ld, 16 if x_vec else 4)]
                        * buffers, formula)
        if placed:
            break
    # the last layout (x read singly, unpadded, one buffer) always fits
    offsets, end = placed
    offsets = offsets[len(head):]
    return LaunchPlan(tm, tn, threads, acc_in_regs, buffers, end, x_vec,
                      x_ld, x_vec and x_ptr % 16 == 0,
                      bn % 4 == 0 and y_ptr % 16 == 0,
                      tuple(offsets[0::2]), tuple(offsets[1::2]))


def _check(x: torch.Tensor, y: torch.Tensor, bm: int, bn: int, bk: int,
           order: str):
    """Shape/dtype/order validation shared by kernel and plain version;
    returns the blocks clamped to the dims (``min(b, dim)``)."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"need (M,K) @ (K,N), got {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")
    if x.dtype != y.dtype:
        raise ValueError(f"operand dtypes differ: {x.dtype} vs {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"operands on {x.device} and {y.device}")
    if order not in ORDERS:
        raise ValueError(f"unknown order {order!r}")
    m, k = x.shape
    n = y.shape[1]
    bm, bn, bk = min(bm, m), min(bn, n), min(bk, k)
    if bm < 1 or bn < 1 or bk < 1 or m % bm or n % bn or k % bk:
        raise ValueError(f"blocks must divide dims: {(m, n, k)} vs "
                         f"{(bm, bn, bk)}")
    return bm, bn, bk


def tiled_matmul_plain(x: torch.Tensor, y: torch.Tensor, *, bm: int = 128,
                       bn: int = 128, bk: int = 128,
                       order: str = "out") -> torch.Tensor:
    """The kernel's arithmetic as a K-block loop of PyTorch ops.

    Each output element depends only on the sequence of K-blocks, so the
    M/N blocking carries no numerics and whole rows of blocks go at once:
    'out' sums float32 partials over K and casts once; 'a'/'b' cast each
    partial to the operand dtype and add in it (int8 wraps).  int8 sums run
    in float64, which holds them exactly (as the kernel's int32 does, and
    as the reference's sums came out where they pass 2^24); float32 would
    round them there."""
    bm, bn, bk = _check(x, y, bm, bn, bk, order)
    m, k = x.shape
    n = y.shape[1]
    acc_dt = torch.float64 if x.dtype == torch.int8 else torch.float32
    if order == "out":
        acc = torch.zeros((m, n), dtype=acc_dt, device=x.device)
        for k0 in range(0, k, bk):
            acc += x[:, k0:k0 + bk].to(acc_dt) @ y[k0:k0 + bk, :].to(acc_dt)
        return cast(acc, x.dtype)
    out = torch.zeros((m, n), dtype=x.dtype, device=x.device)
    for k0 in range(0, k, bk):
        partial = x[:, k0:k0 + bk].to(acc_dt) @ y[k0:k0 + bk, :].to(acc_dt)
        out = out + cast(partial, x.dtype)
    return out


def _bind_mma(lib: ctypes.CDLL):
    """The bfloat16/int8 tensor-core kernel's entry point, which takes its
    launch plan."""
    fn = lib.tiled_matmul_mma_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 24 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bind_f32(lib: ctypes.CDLL):
    """The float32 kernel's entry point, which takes its launch plan."""
    fn = lib.tiled_matmul_f32_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 20 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def tiled_matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int = 128,
                 bn: int = 128, bk: int = 128,
                 order: str = "out") -> torch.Tensor:
    """x: (M, K) @ y: (K, N) -> (M, N) in x's dtype, with explicit T
    (blocks) and O (order).  CPU tensors take :func:`tiled_matmul_plain`;
    CUDA tensors launch the Hopper kernel (counted in
    ``tiled_matmul.launches``) or raise."""
    bm, bn, bk = _check(x, y, bm, bn, bk, order)
    if x.device.type == "cpu":
        return tiled_matmul_plain(x, y, bm=bm, bn=bn, bk=bk, order=order)
    if x.device.type != "cuda":
        raise ValueError(f"tiled_matmul runs on CUDA or CPU tensors, not "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {x.dtype}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("tiled_matmul needs contiguous operands")
    smem = smem_bytes(bm, bn, bk, x.element_size())
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"blocks {(bm, bn, bk)} need {smem} bytes of "
                         f"shared memory, over {SMEM_LIMIT_BYTES}")
    from . import _build

    lib = _build.library("tiled_matmul")
    m, k = x.shape
    n = y.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.float32:
        plan = launch_plan(bm, bn, bk, 4, order, x.data_ptr(), y.data_ptr())
        ys, xs = plan.ys_at * 2, plan.xs_at * 2
        err = _bind_f32(lib)(
            _ORDER_CODE[order], x.data_ptr(), y.data_ptr(), out.data_ptr(),
            m, n, k, bm, bn, bk, plan.tm, plan.tn, plan.threads,
            int(not plan.acc_in_regs), plan.buffers, int(plan.x_vec),
            plan.x_ld, int(plan.x_copy16), int(plan.y_copy16), ys[0], xs[0],
            ys[1], xs[1], plan.smem, stream)
    else:
        p = mma_plan(bm, bn, bk, x.element_size(), order, x.data_ptr(),
                     y.data_ptr(), m, n)
        err = _bind_mma(lib)(
            _DTYPE_CODE[x.dtype], _ORDER_CODE[order], x.data_ptr(),
            y.data_ptr(), out.data_ptr(), m, n, k, bm, bn, bk, p.frag_m,
            p.frag_n, p.warps_m, p.warps_n, p.passes_m, p.passes_n,
            int(not p.acc_in_regs), p.stages, p.x_ld, p.y_ld, p.x_copy,
            p.y_copy, int(p.x_word), p.xs_at, p.ys_at, p.stage_bytes,
            p.group, p.smem, stream)
    if err != 0:
        raise RuntimeError(f"tiled_matmul launch failed with CUDA error "
                           f"{err} (blocks {(bm, bn, bk)}, order {order!r},"
                           f" {x.dtype})")
    tiled_matmul.launches += 1
    return out


tiled_matmul.launches = 0
