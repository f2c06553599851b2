"""Causal flash attention: the hand-written Hopper kernel
(``csrc/flash_attention.cu``) behind :func:`flash_attention`, its plain
PyTorch version :func:`flash_attention_plain`, and the GQA wrapper
:func:`flash_attention_bshd`.

The paper's flexibility axes, at the kernel level: the block sizes
``(bq, bkv)`` are the T axis (legality: blocks divide the sequence and the
block's working set fits shared memory, :func:`smem_bytes`); the O axis is
the q-block-stationary traversal with an online softmax over KV blocks.

The wrapper takes the plain version for CPU tensors only; for a CUDA tensor
it launches the kernel or raises.  :func:`smem_bytes` is the mapping's
shared-memory formula (the bridge's legality tests it); :func:`attention_plan`
decides how one launch runs inside it, on one of the kernel's two bodies:
the CUDA-core body (:func:`core_plan`, float32, and bfloat16 at KV blocks of
one or two keys) or the tensor-core body (:func:`mma_plan`, bfloat16).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from .mamba_scan import starts_aligned

NEG_INF = -1e30
# the formula's warp term: the first version of the kernel ran 4 warps, each
# with a row of bkv float32 probabilities in shared memory.  The kernel now
# runs attention_plan(...).threads and keeps the formula as its budget.
WARPS = 4
# Shared memory one block may use on an H100 (227 KB opt-in; CUDA C++
# Programming Guide, compute capability 9.0 technical specifications).
SMEM_LIMIT_BYTES = 232_448

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The launch plan's limits: CTAs one q-block may be split over, threads of
# one CTA (255 registers a thread), rows of a CTA above which a q-block is
# split (PLAN_ROWS, or WIDE_ROWS where one K/V block takes more than
# WIDE_BLOCK_BYTES: each CTA restages the block, which costs more there than
# the extra CTAs gain), warps a CTA aims for, logits a thread holds in
# registers (rows x keys), keys a lane computes per pass over a block, and
# keys of one staged run of thin KV blocks.
MAX_SPLIT = 8
PLAN_THREADS = 256
PLAN_ROWS = 16
WIDE_ROWS = 32
WIDE_BLOCK_BYTES = 65_536
MIN_WARPS = 4
LOGIT_REGS = 32
MAX_KEYS = 16
RUN_KEYS = 128
# How K and V are staged: one buffer, K and V refilled separately (the next
# K while this block's softmax and P.V run, the next V while the next QK^T
# runs); two buffers, the next run copied while this one is computed; or
# not at all: a CTA of at most DIRECT_ROWS rows reads each K/V value about
# once, so at KV blocks of DIRECT_KEYS keys or more (whose staging would
# leave an SM one such CTA) it reads them straight from device memory, and
# its small shared-memory request lets many CTAs share an SM.
STAGE_SPLIT, STAGE_DOUBLE, STAGE_DIRECT = 0, 1, 2
DIRECT_ROWS = 2
DIRECT_KEYS = 128
# The (vec, rows, keys) shapes csrc/flash_attention.cu instantiates, per
# dtype: 16-byte slabs at 4, 2 or 1 rows a thread with rows * keys <= 32,
# single values at one row a thread.
KERNEL_SHAPES = frozenset(
    [(4, tr, tk) for tr in (1, 2, 4) for tk in (1, 2, 4, 8, 16)
     if tr * tk <= LOGIT_REGS]
    + [(1, 1, tk) for tk in (1, 2, 4, 8, 16)])
# The kernel's two bodies: the CUDA cores (attention_kernel, any dtype) and
# the tensor cores (attention_mma_kernel, bfloat16 on mma.sync m16n8k16).
# 16-bit blocks of fewer than MMA_MIN_KEYS keys stay on the CUDA cores: the
# tensor-core body computes 16 keys a fragment whatever the block holds.  On
# an H100 at BERT-base it was slower at KV blocks of 1 and 2 keys ((64, 1),
# (64, 2), (256, 2)); at 4 keys faster at (256, 4) and (16, 4), even at
# (128, 4) and slower at (1, 4); faster at 8 keys and more.
BODY_CORES, BODY_TENSOR = 0, 1
MMA_MIN_KEYS = 3
# The tensor-core body: a warp owns MMA_ROWS query rows (one m16 fragment);
# a q-block of more than MMA_CTA_ROWS rows is split over up to MAX_SPLIT
# CTAs; up to MAX_KEY_WARPS warps split each KV block's keys, a warp taking
# them CHUNK_KEYS at most at a time (its logits in registers); at most
# PLAN_THREADS threads a CTA.  A d is padded to 16 columns, and each padded
# width up to MMA_MAX_D has one instantiation (MMA_SHAPES: 16-column steps
# of QK^T held in registers, 8-column tiles of the output a column pass).
MMA_ROWS = 16
MMA_CTA_ROWS = 16
MAX_KEY_WARPS = 4
CHUNK_KEYS = 64
MMA_MAX_D = 256
MMA_SHAPES = {16: (1, 2), 32: (2, 4), 64: (4, 8), 128: (8, 16),
              256: (16, 8)}


def smem_bytes(bq: int, bkv: int, d: int, dtype_bytes: float = 2) -> float:
    """The most dynamic shared memory one kernel block may request, the
    mapping's formula (the first kernel's layout: the float32 accumulator,
    running max and sum of the q-block and WARPS probability rows, plus the
    K and V blocks at the operand width, rows padded by one 32-bit word).
    :func:`attention_plan` lays out q, the p slices and K/V inside it."""
    f32 = 4 * (bq * d + 2 * bq + WARPS * bkv)
    return f32 + 2 * bkv * (d * dtype_bytes + 4)


class AttentionPlan(NamedTuple):
    """How one launch runs a (bq, bkv) tile at head width d.

    A q-block is ``split`` CTAs of ``threads`` threads, each CTA owning
    ``bq / split`` rows.  ``run`` KV blocks are staged per barrier as
    ``stage`` says; ``smem`` bytes are requested, at most
    :func:`smem_bytes`.  ``body`` names the kernel's body.

    The CUDA-core body (``body`` 0, ``key_warps`` 1): a thread owns
    ``rows`` row slots (a warp ``warp_rows``), and the ``lanes`` lanes of a
    row group share them: ``key_lanes`` lanes split a KV block's keys,
    ``keys`` keys a lane (the rest of the lanes split d for QK^T);
    ``col_lanes`` lanes split d for P.V, ``vec`` values a lane (the rest
    split each slice's keys).  A d wider than col_lanes * vec runs in
    ``col_passes`` CTAs, a block of more keys than key_lanes * keys in
    ``chunks`` passes.

    The tensor-core body (``body`` 1): a warp owns ``warp_rows`` = 16 rows,
    one m16 fragment, of which each thread holds ``rows`` = 2 and the
    ``lanes`` = 4 lanes of a quad share a row (``key_lanes`` = 4 of them
    split each 8-key tile's logits, ``col_lanes`` = 4 each 8-column output
    tile); ``key_warps`` warps split each KV block's keys, ``keys`` keys a
    warp in each of ``chunks`` chunks; K and V are staged ``vec`` values a
    copy (8: 16-byte cp.async; 1: plain loads); the output's columns run in
    ``col_passes`` CTAs of MMA_SHAPES' width."""
    threads: int
    warp_rows: int
    rows: int
    lanes: int
    key_lanes: int
    col_lanes: int
    keys: int
    vec: int
    split: int
    col_passes: int
    chunks: int
    run: int
    stage: int                   # STAGE_SPLIT | STAGE_DOUBLE | STAGE_DIRECT
    smem: int
    body: int                    # BODY_CORES | BODY_TENSOR
    key_warps: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round16(v: int) -> int:
    return _cdiv(v, 16) * 16


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _layout(cta_rows: int, bkv: int, slabs: int, vec: int, lanes: int,
            key_lanes: int):
    """Lanes, keys and rows a thread for at most ``lanes`` lanes a row of
    which at most ``key_lanes`` split the keys, or None where no rows a
    thread keep the CTA within PLAN_THREADS."""
    kq = min(key_lanes, _pow2_floor(bkv), lanes)
    lr = kq * min(lanes // kq, slabs & -slabs)   # d-split divides slabs
    groups = 32 // lr
    keys = min(_pow2_ceil(_cdiv(bkv, kq)), MAX_KEYS)
    while keys >= 1:
        fits = [tr for tr in ((4, 2, 1) if vec == 4 else (1,))
                if tr * keys <= LOGIT_REGS
                and _cdiv(cta_rows, groups * tr) * 32 <= PLAN_THREADS]
        if fits:
            break
        keys //= 2
    else:
        return None
    # the most rows a thread that still give MIN_WARPS warps, else the
    # fewest (the most warps)
    tr = next((t for t in fits if _cdiv(cta_rows, groups * t) >= MIN_WARPS),
              fits[-1])
    return lr, kq, keys, tr, _cdiv(cta_rows, groups * tr)


@functools.lru_cache(maxsize=4096)
def attention_plan(bq: int, bkv: int, d: int, dtype_bytes: int = 4,
                   aligned: bool = True) -> AttentionPlan:
    """The launch plan of blocks (bq, bkv) at head width ``d`` and operand
    width ``dtype_bytes`` (4 or 2); ``aligned``: q, k, v and the output
    start on 16 bytes.

    The body, from the shape alone: 16-bit operands at bkv >= MMA_MIN_KEYS
    and d <= MMA_MAX_D run on the tensor cores (:func:`mma_plan`) wherever
    its layout fits the formula, at any bq; every other shape (KV blocks of
    one or two keys, a d over MMA_MAX_D), and every float32 one, runs on the
    CUDA cores (:func:`core_plan`).  Cached: the wrapper asks for it on
    every call, and the autotune times single calls."""
    if dtype_bytes == 2 and bkv >= MMA_MIN_KEYS and d <= MMA_MAX_D:
        plan = mma_plan(bq, bkv, d, aligned)
        if plan is not None:
            return plan
    return core_plan(bq, bkv, d, dtype_bytes, aligned)


@functools.lru_cache(maxsize=4096)
def core_plan(bq: int, bkv: int, d: int, dtype_bytes: int = 4,
              aligned: bool = True) -> AttentionPlan:
    """The CUDA-core body's plan of blocks (bq, bkv) at head width ``d``
    and operand width ``dtype_bytes`` (bfloat16 is converted on load).

    A q-block of more than PLAN_ROWS rows (WIDE_ROWS at K/V blocks of more
    than WIDE_BLOCK_BYTES) is split over up to MAX_SPLIT plain CTAs.  A
    block of 32 keys or more runs 32 lanes a row, each computing whole dot
    products of its keys (no lane reads a K row that a neighbour reads
    too).  Otherwise a row's lanes are 16 (32 at d >= 128): as many as the
    block has keys (up to 16) split the keys, the rest split d.  Where the
    p slices do not fit the formula beside q and one K/V block, fewer lanes
    split the keys, then fewer lanes share a row.  Thin KV blocks are
    staged RUN_KEYS keys at a time; where two runs fit they are double
    buffered.  A CTA of at most DIRECT_ROWS rows at blocks of DIRECT_KEYS
    keys or more stages none."""
    formula = int(smem_bytes(bq, bkv, d, dtype_bytes))
    vec = 4 if aligned and d % 4 == 0 else 1
    slabs = d // vec
    block_bytes = 2 * bkv * d * dtype_bytes
    most = WIDE_ROWS if block_bytes > WIDE_BLOCK_BYTES else PLAN_ROWS
    divs = [k for k in range(1, MAX_SPLIT + 1) if bq % k == 0]
    split = next((k for k in divs if bq // k <= most), divs[-1])
    cta_rows = bq // split
    q_bytes = _round16(4 * cta_rows * d)
    direct = cta_rows <= DIRECT_ROWS and bkv >= DIRECT_KEYS
    top = 32 if slabs >= 32 else 16
    tries = ([(32, 32)] if bkv >= 32 else []) + [
        (lanes, kq) for lanes in (top, top // 2, top // 4, top // 8)
        for kq in (16, 8, 4, 2, 1)] + [(1, 1)]
    for lanes, kq in tries:
        layout = _layout(cta_rows, bkv, slabs, vec, lanes, kq)
        if layout is None:
            continue
        lr, kq, keys, tr, warps = layout
        warp_rows = (32 // lr) * tr
        p_bytes = 0 if lr == 1 else _round16(8 * warps * warp_rows * kq)
        free = formula - q_bytes - p_bytes
        if free >= (0 if direct else block_bytes):
            break
    fit = free // block_bytes
    if direct:
        stage, run = STAGE_DIRECT, 1
    elif fit >= 2:
        stage, run = STAGE_DOUBLE, min(fit // 2, max(1, RUN_KEYS // bkv))
    else:
        stage, run = STAGE_SPLIT, 1
    col_lanes = min(lr, _pow2_floor(slabs))
    return AttentionPlan(
        threads=32 * warps, warp_rows=warp_rows, rows=tr, lanes=lr,
        key_lanes=kq, col_lanes=col_lanes, keys=keys, vec=vec, split=split,
        col_passes=_cdiv(slabs, col_lanes), chunks=_cdiv(bkv, kq * keys),
        run=run, stage=stage,
        smem=q_bytes + p_bytes + (0, 1, 2)[(STAGE_DIRECT, STAGE_SPLIT,
                                             STAGE_DOUBLE).index(stage)]
        * run * block_bytes, body=BODY_CORES, key_warps=1)


def _mma_layout(bq: int, bkv: int, d: int, split: int, key_warps: int,
                stage: int, run: int):
    """The tensor-core body's shared memory, as csrc/flash_attention.cu
    lays it out: q (the CTA's rows at the padded width), two slots of the
    key warps' row maxima (none at one key warp), then K and V (``run``
    blocks, once or twice), whose bytes the key warps' accumulators reuse
    for their sum at the end.  Returns (slots offset, K/V offset, bytes)."""
    dpad = _cdiv(d, 16) * 16
    rows = bq // split
    rows_pad = _cdiv(rows, MMA_ROWS) * MMA_ROWS
    q_bytes = _round16(2 * rows * dpad)
    slot_bytes = 0 if key_warps == 1 else _round16(8 * key_warps * rows_pad)
    bufs = 2 if stage == STAGE_DOUBLE else 1
    kv_bytes = 2 * bufs * run * bkv * dpad * 2
    cols = MMA_SHAPES[_mma_width(dpad)][1] * 8
    red_bytes = 0 if key_warps == 1 else \
        4 * key_warps * rows_pad * (cols + 4 + 1)
    kv_at = q_bytes + slot_bytes
    return q_bytes, kv_at, kv_at + max(kv_bytes, red_bytes)


def _mma_width(dpad: int) -> int:
    return min(w for w in MMA_SHAPES if w >= dpad)


@functools.lru_cache(maxsize=4096)
def mma_plan(bq: int, bkv: int, d: int,
             aligned: bool = True) -> Optional[AttentionPlan]:
    """The tensor-core body's plan of bfloat16 blocks (bq, bkv) at head
    width ``d`` (at most MMA_MAX_D), or None where no layout fits the
    formula.  It does not apply :func:`attention_plan`'s rule: any blocks
    run (rows past the CTA's and keys past the block are computed on
    clamped rows, then masked or not stored), which times this body at
    thin blocks beside the CUDA-core body.

    A q-block of more than MMA_CTA_ROWS rows is split over up to MAX_SPLIT
    CTAs; a CTA's rows go to warps of 16.  The most key warps (up to
    MAX_KEY_WARPS, at most PLAN_THREADS threads) that leave no warp without
    keys split each KV block, each taking its keys in chunks of at most
    CHUNK_KEYS; where the layout does not fit the formula, fewer.  Two
    K/V buffers (``run`` blocks each, up to RUN_KEYS keys) where they fit
    the formula and leave room for a second CTA on the SM, else one,
    refilled K and V apart."""
    if d > MMA_MAX_D:
        return None
    dpad = _cdiv(d, 16) * 16
    formula = int(smem_bytes(bq, bkv, d, 2))
    divs = [k for k in range(1, MAX_SPLIT + 1) if bq % k == 0]
    split = next((k for k in divs if bq // k <= MMA_CTA_ROWS), divs[-1])
    row_warps = _cdiv(bq // split, MMA_ROWS)
    if 32 * row_warps > PLAN_THREADS:
        return None
    keys16 = _cdiv(bkv, 16)
    block_bytes = 2 * bkv * dpad * 2
    top = max(1, min(MAX_KEY_WARPS, keys16,
                     PLAN_THREADS // (32 * row_warps)))
    for want in range(top, 0, -1):
        per_warp = _cdiv(keys16, want)        # 16-key steps a warp
        key_warps = _cdiv(keys16, per_warp)   # no warp without keys
        chunks = _cdiv(per_warp * 16, CHUNK_KEYS)
        keys = 16 * _cdiv(per_warp, chunks)
        tries = []
        _, kv_at, _ = _mma_layout(bq, bkv, d, split, key_warps,
                                  STAGE_SPLIT, 1)
        fit = (formula - kv_at) // block_bytes
        if fit >= 2:
            run = min(fit // 2, max(1, RUN_KEYS // bkv))
            tries.append((STAGE_DOUBLE, run))
        tries.append((STAGE_SPLIT, 1))
        for stage, run in tries:
            smem = _mma_layout(bq, bkv, d, split, key_warps, stage, run)[2]
            if smem > formula or (stage == STAGE_DOUBLE
                                  and 2 * smem > SMEM_LIMIT_BYTES):
                continue
            return AttentionPlan(
                threads=32 * row_warps * key_warps, warp_rows=MMA_ROWS,
                rows=2, lanes=4, key_lanes=4, col_lanes=4, keys=keys,
                vec=8 if aligned and d % 8 == 0 else 1, split=split,
                col_passes=_cdiv(dpad,
                                 MMA_SHAPES[_mma_width(dpad)][1] * 8),
                chunks=chunks, run=run, stage=stage, smem=smem,
                body=BODY_TENSOR, key_warps=key_warps)
    return None


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bq: int,
           bkv: int):
    """Shape/dtype validation shared by kernel and plain version; returns
    the blocks clamped to the sequence lengths (``min(b, S)``)."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"need q (H,Sq,d), k and v (H,Skv,d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"operand dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")
    sq, skv = q.shape[1], k.shape[1]
    bq, bkv = min(bq, sq), min(bkv, skv)
    if bq < 1 or bkv < 1 or sq % bq or skv % bkv:
        raise ValueError(f"blocks must divide the sequences: {(sq, skv)} "
                         f"vs {(bq, bkv)}")
    return bq, bkv


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          bq: int = 256, bkv: int = 256,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's arithmetic as a KV-block loop of PyTorch ops.

    Each query row sees the same sequence of KV blocks whatever q-block it
    sits in, so the rows of all q-blocks go at once; the q-blocking only
    decides which KV blocks a row skips (those strictly above its block's
    diagonal), which the loop applies as a per-row mask."""
    bq, bkv = _check(q, k, v, bq, bkv)
    h, sq, d = q.shape
    skv = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    qs = q.float() * scale
    kf, vf = k.float(), v.float()
    q_pos = torch.arange(sq, device=dev)
    q_last = (q_pos // bq) * bq + bq - 1       # last row of each q-block
    m = torch.full((h, sq, 1), NEG_INF, device=dev)
    l = torch.zeros((h, sq, 1), device=dev)
    acc = torch.zeros((h, sq, d), device=dev)
    for k0 in range(0, skv, bkv):
        logits = qs @ kf[:, k0:k0 + bkv].transpose(1, 2)
        if causal:
            kv_pos = torch.arange(k0, k0 + bkv, device=dev)
            logits = torch.where(q_pos[:, None] >= kv_pos[None, :], logits,
                                 NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1, keepdim=True)
        acc_new = acc * corr + p @ vf[:, k0:k0 + bkv]
        if causal:
            live = (k0 <= q_last)[None, :, None]
            m_new = torch.where(live, m_new, m)
            l_new = torch.where(live, l_new, l)
            acc_new = torch.where(live, acc_new, acc)
        m, l, acc = m_new, l_new, acc_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _bind(lib: ctypes.CDLL):
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 7 + [ctypes.c_float]
                       + [ctypes.c_int] * len(AttentionPlan._fields)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, bq: int, bkv: int, scale: float,
           plan: AttentionPlan) -> torch.Tensor:
    """Launch the kernel on CUDA operands that :func:`flash_attention` has
    checked, with ``plan``; the kernel checks the plan again and refuses a
    bad one, which raises here."""
    from . import _build

    h, sq, d = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bind(_build.library("flash_attention"))(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), h, sq, k.shape[1], d, bq, bkv, int(causal), scale,
        *plan, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error "
                           f"{err} (blocks {(bq, bkv)}, d={d}, {q.dtype}, "
                           f"{plan})")
    flash_attention.launches += 1
    flash_attention.body_launches[plan.body] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 256, bkv: int = 256,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (H, Sq, d), k/v: (H, Skv, d) — one batch-flattened head axis;
    returns (H, Sq, d) in q's dtype.  CPU tensors take
    :func:`flash_attention_plain`; CUDA tensors launch the Hopper kernel
    with :func:`attention_plan`'s plan (counted in
    ``flash_attention.launches``, and by body in
    ``flash_attention.body_launches``, indexed by BODY_CORES and
    BODY_TENSOR) or raise."""
    bq, bkv = _check(q, k, v, bq, bkv)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, bq=bq, bkv=bkv,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous operands")
    h, sq, d = q.shape
    if h > 65_535:
        raise ValueError(f"{h} heads exceed the grid's y limit of 65535")
    smem = smem_bytes(bq, bkv, d, q.element_size())
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"blocks {(bq, bkv)} at d={d} need {smem} bytes of "
                         f"shared memory, over {SMEM_LIMIT_BYTES}")
    scale = d ** -0.5 if scale is None else scale
    plan = attention_plan(bq, bkv, d, q.element_size(),
                          starts_aligned(q, k, v))
    return launch(q, k, v, causal=causal, bq=bq, bkv=bkv, scale=scale,
                  plan=plan)


flash_attention.launches = 0
flash_attention.body_launches = [0, 0]


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, bq: int = 256,
                         bkv: int = 256) -> torch.Tensor:
    """(B, S, H, d) GQA layout wrapper: KV heads repeat to the query heads
    (``jnp.repeat`` on the head axis), heads flatten into the batch."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qf = q.permute(0, 2, 1, 3).reshape(b * hq, sq, d)
    kf = k.permute(0, 2, 1, 3).repeat_interleave(group, dim=1
                                                 ).reshape(b * hq, skv, d)
    vf = v.permute(0, 2, 1, 3).repeat_interleave(group, dim=1
                                                 ).reshape(b * hq, skv, d)
    o = flash_attention(qf, kf, vf, causal=causal, bq=bq, bkv=bkv)
    return o.reshape(b, hq, sq, d).permute(0, 2, 1, 3)
