"""Chunked selective scan (the Mamba-1 recurrence): the hand-written Hopper
kernel (``csrc/mamba_scan.cu``) behind :func:`mamba_scan`, and its plain
PyTorch version :func:`mamba_scan_plain`.

    h_t = exp(dt_t ⊗ A) * h_{t-1} + (dt_t * x_t) ⊗ B_t
    y_t = <h_t, C_t> + D * x_t

The paper's T axis is the (chunk, d_block) tile; the O axis is the
chunk-major traversal that keeps the state h stationary.

:func:`smem_bytes` is the mapping's shared-memory formula (the bridge's
legality tests it); :func:`scan_plan` decides how one launch runs inside
it.  The wrapper takes the plain version for CPU tensors only; for a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

# Shared memory one block may use on an H100 (227 KB opt-in; CUDA C++
# Programming Guide, compute capability 9.0 technical specifications).
SMEM_LIMIT_BYTES = 232_448
MAX_THREADS = 1024      # threads of one kernel block (the formula's term)
MAX_STATE = 128         # d_state the kernel takes
# The launch plan's limits: states a thread may own, threads of one CTA
# (255 registers a thread), and CTAs one d-block may be split over (8, so
# that a d-block stays a unit of the size of a portable cluster).
STATES = (1, 2, 4, 8, 16)
PLAN_THREADS = 256
MAX_SPLIT = 8
# How the next chunk is staged: loaded into registers while the current
# chunk runs; by cp.async into each half of the buffer while the other half
# runs; or not ahead (the chunk is copied, then run).
STAGE_SYNC, STAGE_REGISTERS, STAGE_HALVES = 0, 1, 2


def state_lanes(n: int) -> int:
    """Threads that share one channel's N states: N rounded up to a power
    of two, at most 32 (a warp).  A term of :func:`smem_bytes`; the kernel
    itself spreads a channel over ``scan_plan(...).lanes`` threads."""
    lanes = 1
    while lanes < min(n, 32):
        lanes *= 2
    return lanes


def channel_group(d_block: int, n: int) -> int:
    """Channels one kernel block stages at once under :func:`smem_bytes`
    (a term of the formula).  :func:`scan_plan` spreads a wider d-block
    over up to ``MAX_SPLIT`` blocks, each staging at most this many."""
    return min(d_block, MAX_THREADS // state_lanes(n))


def smem_bytes(chunk: int, d_block: int, n: int,
               dtype_bytes: float = 4) -> float:
    """The most dynamic shared memory one kernel block may request: the
    chunk's x, dt and y for one pass of channels and its b and c, at the
    operand width (the state h and A, D stay in registers).  The kernel
    stores y straight from registers, so it requests the b, c, x and dt
    thirds only (:func:`scan_plan`)."""
    group = channel_group(d_block, n)
    return (3 * chunk * group + 2 * chunk * n) * dtype_bytes


class ScanPlan(NamedTuple):
    """How one launch runs a (chunk, d_block) tile at d_state N.

    Each thread owns ``states`` of one channel's N states, a channel
    spreads over ``lanes`` threads (``states * lanes >= N``), and a CTA
    runs ``channels`` channels at once.  A d-block is ``split`` CTAs,
    each owning ``d_block / split`` of its channels in ``passes``
    passes.  ``smem`` bytes are requested, at most :func:`smem_bytes`."""
    states: int
    lanes: int
    channels: int
    threads: int
    split: int
    passes: int
    stage: int                   # STAGE_SYNC | STAGE_REGISTERS | STAGE_HALVES
    vec_x: int                   # floats a copy of x and dt: 4 or 1
    vec_bc: int                  # floats a copy of b and c: 4 or 1
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def cta_channels(d_block: int, n: int) -> int:
    """Channels one CTA may run in a pass: what the formula lets it stage
    (:func:`channel_group`), and at most ``PLAN_THREADS`` threads of up to
    16 states each."""
    return min(channel_group(d_block, n),
               PLAN_THREADS // max(1, _pow2(n) // 16))


def scan_plan(chunk: int, d_block: int, n: int,
              aligned: bool = True) -> ScanPlan:
    """The launch plan of blocks (chunk, d_block) at d_state ``n``
    (1..128); ``aligned``: x, dt, b and c start on 16 bytes.

    A d-block wider than :func:`cta_channels` is split over up to 8 plain
    CTAs (no thread-block cluster: they share nothing), each staging its
    share of the channels within the formula; passes remain only where 8
    CTAs cannot hold the d-block.  One buffer holds the chunk's b, c, x
    and dt (y goes straight to device memory, so the formula's y third
    stays free).  The next chunk is staged ahead in registers where a
    thread's share is one vector an operand, else by ``cp.async`` into
    each half of the buffer while the other half runs, else (a chunk of
    one step) not ahead."""
    group = cta_channels(d_block, n)
    divs = [k for k in range(1, MAX_SPLIT + 1) if d_block % k == 0]
    fits = [k for k in divs if d_block // k <= group]
    split = fits[0] if fits else divs[-1]
    width = d_block // split
    passes = _cdiv(width, group)
    channels = _cdiv(width, passes)
    npad = _pow2(n)
    legal = [s for s in STATES if s <= npad and npad // s <= 32
             and channels * (npad // s) <= PLAN_THREADS]
    # fewest instructions a state (4 states share one float4 of b and of c,
    # and a channel's shuffle tree), as long as a CTA keeps a whole warp;
    # a CTA short of a warp anyway takes 2 states a thread
    fill = [s for s in legal if s <= 4 and channels * (npad // s) >= 32]
    states = max(legal[0], fill[-1] if fill else min(2, npad))
    lanes = npad // states
    threads = _cdiv(channels * lanes, 32) * 32
    vec_x = 4 if (aligned and channels % 4 == 0 and width % 4 == 0
                  and d_block % 4 == 0 and (2 * chunk * n) % 4 == 0) else 1
    vec_bc = 4 if aligned and n % 4 == 0 else 1
    if (chunk * channels // vec_x <= threads
            and chunk * n // vec_bc <= threads):
        stage = STAGE_REGISTERS
    else:
        stage = STAGE_HALVES if chunk >= 2 else STAGE_SYNC
    return ScanPlan(states, lanes, channels, threads, split,
                    _cdiv(width, channels), stage, vec_x, vec_bc,
                    4 * chunk * (2 * n + 2 * channels))


def _check(x, dt, b, c, a_log_neg, d_skip, chunk: int, d_block: int):
    """Shape validation shared by kernel and plain version; returns the
    blocks clamped to the dims (``min(chunk, L)``, ``min(d_block, D)``)."""
    if x.dim() != 3 or dt.shape != x.shape or b.dim() != 3 \
            or c.shape != b.shape or b.shape[:2] != x.shape[:2]:
        raise ValueError(f"need x, dt (B,L,D) and b, c (B,L,N), got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    bsz, length, dim = x.shape
    n = b.shape[-1]
    if tuple(a_log_neg.shape) != (dim, n) or tuple(d_skip.shape) != (dim,):
        raise ValueError(f"need a_log_neg (D,N) = {(dim, n)} and d_skip "
                         f"(D,), got {tuple(a_log_neg.shape)}, "
                         f"{tuple(d_skip.shape)}")
    devices = {t.device for t in (x, dt, b, c, a_log_neg, d_skip)}
    if len(devices) != 1:
        raise ValueError(f"operands on {sorted(map(str, devices))}")
    chunk, d_block = min(chunk, length), min(d_block, dim)
    if chunk < 1 or d_block < 1 or length % chunk or dim % d_block:
        raise ValueError(f"blocks must divide (L, D) = {(length, dim)}: "
                         f"{(chunk, d_block)}")
    return chunk, d_block


def mamba_scan_plain(x, dt, b, c, a_log_neg, d_skip, *, chunk: int = 128,
                     d_block: int = 512) -> torch.Tensor:
    """The kernel's recurrence as a loop over chunks and their steps, every
    channel of every batch at once (channels are independent, so the
    d-blocking carries no numerics; the state carries across chunks)."""
    chunk, d_block = _check(x, dt, b, c, a_log_neg, d_skip, chunk, d_block)
    bsz, length, dim = x.shape
    n = b.shape[-1]
    xf, dtf, bf, cf = (t.float() for t in (x, dt, b, c))
    a = a_log_neg.float()[None]
    dsk = d_skip.float()[None]
    h = torch.zeros((bsz, dim, n), device=x.device)
    y = torch.empty((bsz, length, dim), device=x.device)
    for t0 in range(0, length, chunk):
        for t in range(t0, t0 + chunk):
            xt, dtt = xf[:, t], dtf[:, t]
            decay = torch.exp(dtt[..., None] * a)
            h = decay * h + (dtt * xt)[..., None] * bf[:, t, None, :]
            y[:, t] = (h * cf[:, t, None, :]).sum(dim=-1) + dsk * xt
    return y.to(x.dtype)


def _bind(lib: ctypes.CDLL):
    fn = lib.mamba_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 17 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def starts_aligned(*tensors) -> bool:
    """Every tensor starts on 16 bytes (16-byte copies are legal)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def launch(x, dt, b, c, a_log_neg, d_skip, *, chunk: int, d_block: int,
           plan: ScanPlan) -> torch.Tensor:
    """Launch the kernel on CUDA operands that :func:`mamba_scan` has
    checked, with ``plan``; the kernel checks the plan again and refuses a
    bad one, which raises here."""
    from . import _build

    bsz, length, dim = x.shape
    n = b.shape[-1]
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _bind(_build.library("mamba_scan"))(
        *(t.data_ptr() for t in (x, dt, b, c, a_log_neg, d_skip)),
        y.data_ptr(), bsz, length, dim, n, chunk, d_block, plan.states,
        plan.lanes, plan.channels, plan.threads, plan.split, plan.passes,
        plan.stage, plan.vec_x, plan.vec_bc, plan.smem,
        int(smem_bytes(chunk, d_block, n, 4)), stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed with CUDA error {err} "
                           f"(blocks {(chunk, d_block)}, N={n}, {plan})")
    mamba_scan.launches += 1
    return y


def mamba_scan(x, dt, b, c, a_log_neg, d_skip, *, chunk: int = 128,
               d_block: int = 512) -> torch.Tensor:
    """x, dt: (B, L, D); b, c: (B, L, N); a_log_neg: (D, N) (= -exp(A_log));
    d_skip: (D,).  Returns y: (B, L, D) in x's dtype.  CPU tensors take
    :func:`mamba_scan_plain`; CUDA tensors launch the Hopper kernel with
    :func:`scan_plan`'s plan (counted in ``mamba_scan.launches``) or
    raise."""
    chunk, d_block = _check(x, dt, b, c, a_log_neg, d_skip, chunk, d_block)
    if x.device.type == "cpu":
        return mamba_scan_plain(x, dt, b, c, a_log_neg, d_skip, chunk=chunk,
                                d_block=d_block)
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan runs on CUDA or CPU tensors, not "
                         f"{x.device}")
    ops = (x, dt, b, c, a_log_neg, d_skip)
    if any(t.dtype != torch.float32 for t in ops):
        raise ValueError("mamba_scan runs float32 operands only, got "
                         f"{[str(t.dtype) for t in ops]}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("mamba_scan needs contiguous operands")
    bsz = x.shape[0]
    n = b.shape[-1]
    if n > MAX_STATE:
        raise ValueError(f"d_state {n} over the kernel's {MAX_STATE}")
    if bsz > 65_535:
        raise ValueError(f"batch {bsz} exceeds the grid's y limit of 65535")
    smem = smem_bytes(chunk, d_block, n, 4)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"blocks {(chunk, d_block)} at N={n} need {smem} "
                         f"bytes of shared memory, over {SMEM_LIMIT_BYTES}")
    plan = scan_plan(chunk, d_block, n, starts_aligned(x, dt, b, c))
    return launch(*ops, chunk=chunk, d_block=d_block, plan=plan)


mamba_scan.launches = 0
