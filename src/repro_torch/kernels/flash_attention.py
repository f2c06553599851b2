"""Causal flash attention: the hand-written Hopper kernel
(``csrc/flash_attention.cu``) behind :func:`flash_attention`, its plain
PyTorch version :func:`flash_attention_plain`, and the GQA wrapper
:func:`flash_attention_bshd`.

The paper's flexibility axes, at the kernel level: the block sizes
``(bq, bkv)`` are the T axis (legality: blocks divide the sequence and the
block's working set fits shared memory, :func:`smem_bytes`); the O axis is
the q-block-stationary traversal with an online softmax over KV blocks.

The wrapper takes the plain version for CPU tensors only; for a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30
# warps of one kernel block (kWarps in the source); each owns a per-warp
# row of bkv float32 probabilities in shared memory
WARPS = 4
# Shared memory one block may use on an H100 (227 KB opt-in; CUDA C++
# Programming Guide, compute capability 9.0 technical specifications).
SMEM_LIMIT_BYTES = 232_448

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(bq: int, bkv: int, d: int, dtype_bytes: float = 2) -> float:
    """Dynamic shared memory one kernel block requests: the float32
    accumulator, running max and sum of the q-block and the per-warp
    probability rows, plus the K and V blocks at the operand width (rows
    padded by one 32-bit word).  The q rows are read from device memory."""
    f32 = 4 * (bq * d + 2 * bq + WARPS * bkv)
    return f32 + 2 * bkv * (d * dtype_bytes + 4)


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
                       + [ctypes.c_int] * 7 + [ctypes.c_float,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 256, bkv: int = 256,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (H, Sq, d), k/v: (H, Skv, d) — one batch-flattened head axis;
    returns (H, Sq, d) in q's dtype.  CPU tensors take
    :func:`flash_attention_plain`; CUDA tensors launch the Hopper kernel
    (counted in ``flash_attention.launches``) or raise."""
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
    skv = k.shape[1]
    if h > 65_535:
        raise ValueError(f"{h} heads exceed the grid's y limit of 65535")
    smem = smem_bytes(bq, bkv, d, q.element_size())
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"blocks {(bq, bkv)} at d={d} need {smem} bytes of "
                         f"shared memory, over {SMEM_LIMIT_BYTES}")
    from . import _build

    launch = _bind(_build.library("flash_attention"))
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = launch(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), h, sq, skv, d, bq, bkv,
                 int(causal), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error "
                           f"{err} (blocks {(bq, bkv)}, d={d}, {q.dtype})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


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
