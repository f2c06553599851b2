"""Chunked selective scan (the Mamba-1 recurrence): the hand-written Hopper
kernel (``csrc/mamba_scan.cu``) behind :func:`mamba_scan`, and its plain
PyTorch version :func:`mamba_scan_plain`.

    h_t = exp(dt_t ⊗ A) * h_{t-1} + (dt_t * x_t) ⊗ B_t
    y_t = <h_t, C_t> + D * x_t

The paper's T axis is the (chunk, d_block) tile; the O axis is the
chunk-major traversal that keeps the state h stationary.

The wrapper takes the plain version for CPU tensors only; for a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

# Shared memory one block may use on an H100 (227 KB opt-in; CUDA C++
# Programming Guide, compute capability 9.0 technical specifications).
SMEM_LIMIT_BYTES = 232_448
MAX_THREADS = 1024      # threads of one kernel block
MAX_PER_LANE = 4        # states one thread carries (kMaxPerLane)


def state_lanes(n: int) -> int:
    """Threads that share one channel's N states: N rounded up to a power
    of two, at most 32 (a warp)."""
    lanes = 1
    while lanes < min(n, 32):
        lanes *= 2
    return lanes


def channel_group(d_block: int, n: int) -> int:
    """Channels a kernel block runs at once; it loops over the rest of its
    d-block in passes of this many."""
    return min(d_block, MAX_THREADS // state_lanes(n))


def smem_bytes(chunk: int, d_block: int, n: int,
               dtype_bytes: float = 4) -> float:
    """Dynamic shared memory one kernel block requests: the chunk's x, dt
    and y for one pass of channels and its b and c, at the operand width
    (the state h and A, D stay in registers)."""
    group = channel_group(d_block, n)
    return (3 * chunk * group + 2 * chunk * n) * dtype_bytes


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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def mamba_scan(x, dt, b, c, a_log_neg, d_skip, *, chunk: int = 128,
               d_block: int = 512) -> torch.Tensor:
    """x, dt: (B, L, D); b, c: (B, L, N); a_log_neg: (D, N) (= -exp(A_log));
    d_skip: (D,).  Returns y: (B, L, D) in x's dtype.  CPU tensors take
    :func:`mamba_scan_plain`; CUDA tensors launch the Hopper kernel
    (counted in ``mamba_scan.launches``) or raise."""
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
    bsz, length, dim = x.shape
    n = b.shape[-1]
    lanes = state_lanes(n)
    if n > MAX_PER_LANE * lanes:
        raise ValueError(f"d_state {n} over the kernel's "
                         f"{MAX_PER_LANE * lanes}")
    if bsz > 65_535:
        raise ValueError(f"batch {bsz} exceeds the grid's y limit of 65535")
    smem = smem_bytes(chunk, d_block, n, 4)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"blocks {(chunk, d_block)} at N={n} need {smem} "
                         f"bytes of shared memory, over {SMEM_LIMIT_BYTES}")
    from . import _build

    launch = _bind(_build.library("mamba_scan"))
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = launch(*(t.data_ptr() for t in ops), y.data_ptr(), bsz, length,
                 dim, n, chunk, d_block, lanes, channel_group(d_block, n),
                 stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed with CUDA error {err} "
                           f"(blocks {(chunk, d_block)}, N={n})")
    mamba_scan.launches += 1
    return y


mamba_scan.launches = 0
