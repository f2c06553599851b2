"""Causal attention for the model path: the hand-written Hopper kernels of
``csrc/attention_train.cu`` (a bfloat16 flash forward on the tensor cores
that also writes each row's log-sum-exp, and its deterministic backward) as
one autograd op, :func:`attention_train`, beside their plain PyTorch
versions :func:`forward_plain` and :func:`backward_plain`.

The op takes q (B, Sq, H, d) and k, v (B, Skv, KV, d) in the model's
``split_heads`` layout, read in place through their strides; query head h
reads KV head ``h // (H // KV)``.  The mask is causal with a host offset:
query i sits at position ``q_offset + i`` and sees keys 0 .. q_offset + i
(``Skv >= q_offset + Sq``; a KV cache's unfilled tail lies above every
query's diagonal).  CPU tensors take the plain versions, in their own
dtype; CUDA tensors launch the kernels (bfloat16, d in :data:`WIDTHS`) or
raise, as fake tensors do.  Launches are counted in ``attention_train.launches`` (forward)
and ``attention_train.backward_launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

# The head widths csrc/attention_train.cu instantiates, one each.
WIDTHS = (64, 80, 96, 128)
# Keys of the kernel's KV tile (kBlockN): the plain forward's online
# softmax steps by the same tiles, so its rounding of P follows the kernel.
BLOCK_N = 64
LOG2E = 1.4426950408889634


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"need q (B,Sq,H,d), k and v (B,Skv,KV,d) with KV "
                         f"dividing H, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"operand dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")
    if q_offset < 0 or q_offset + q.shape[1] > k.shape[1]:
        raise ValueError(f"queries at {q_offset}..{q_offset + q.shape[1]} "
                         f"need that many keys, got {k.shape[1]}")


def _by_head(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, KV, d) -> (B, H, S, d) float32, each KV head repeated for the
    query heads of its group."""
    group = heads // t.shape[2]
    return t.float().permute(0, 2, 1, 3).repeat_interleave(group, dim=1)


def _causal(sq: int, n0: int, n: int, q_offset: int, device) -> torch.Tensor:
    """(sq, n) True where query i (at q_offset + i) sees key n0 + j."""
    pos = q_offset + torch.arange(sq, device=device)
    return torch.arange(n0, n0 + n, device=device)[None, :] <= pos[:, None]


def forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset: int, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's arithmetic as a loop over KV tiles of BLOCK_N
    keys: float32 logits times ``scale * log2(e)``, an online base-2
    softmax, P rounded to q's dtype before P.V, float32 sums.  Returns o
    (B, Sq, H, d) in q's dtype and lse (B, H, Sq) float32, the base-2
    log-sum-exp of the scaled logits."""
    b, sq, h, d = q.shape
    qh = q.float().permute(0, 2, 1, 3)
    kh, vh = _by_head(k, h), _by_head(v, h)
    m = torch.full((b, h, sq), -math.inf, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    c = scale * LOG2E
    for n0 in range(0, q_offset + sq, BLOCK_N):
        kt, vt = kh[:, :, n0:n0 + BLOCK_N], vh[:, :, n0:n0 + BLOCK_N]
        s = (qh @ kt.transpose(-1, -2)) * c
        s = torch.where(_causal(sq, n0, kt.shape[2], q_offset, q.device),
                        s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p.to(q.dtype).float() @ vt
        m = m_new
    o = (acc / l[..., None]).to(q.dtype).permute(0, 2, 1, 3).contiguous()
    return o, m + torch.log2(l)


def _split(ds: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """dS as the backward's products see it: at 16 bits, the hi + lo pair
    of bfloat16 values (hi rounds dS, lo rounds dS - hi); float32 as it is."""
    if dtype == torch.float32:
        return ds
    hi = ds.to(dtype)
    return hi.float() + (ds - hi.float()).to(dtype).float()


def backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   q_offset: int, scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' arithmetic: P recomputed from ``lse``, delta =
    rowsum(dO * O), dS = P * (dO V^T - delta), dV = P^T dO with P in q's
    dtype, dQ = scale dS K and dK = scale dS^T Q with dS as :func:`_split`
    gives it; float32 sums, each query head's dK and dV summed into its KV
    head.  Returns dq, dk, dv in the operands' shapes and dtype."""
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    qh = q.float().permute(0, 2, 1, 3)
    kh, vh = _by_head(k, h), _by_head(v, h)
    doh = do.float().permute(0, 2, 1, 3)
    s = (qh @ kh.transpose(-1, -2)) * (scale * LOG2E)
    p = torch.where(_causal(sq, 0, skv, q_offset, q.device),
                    torch.exp2(s - lse[..., None]), 0.0)
    delta = (doh * o.float().permute(0, 2, 1, 3)).sum(dim=-1)
    ds = _split(p * (doh @ vh.transpose(-1, -2) - delta[..., None]), q.dtype)
    dq = scale * (ds @ kh)
    dk = scale * (ds.transpose(-1, -2) @ qh)
    dv = p.to(q.dtype).float().transpose(-1, -2) @ doh

    def to_kv(t):     # (B, H, Skv, d) -> (B, Skv, KV, d), the group summed
        return t.reshape(b, kv, h // kv, skv, d).sum(dim=2).permute(
            0, 2, 1, 3).to(q.dtype).contiguous()

    return (dq.permute(0, 2, 1, 3).to(q.dtype).contiguous(), to_kv(dk),
            to_kv(dv))


def _fits(t: torch.Tensor) -> bool:
    """d contiguous, the other strides whole 16-byte slabs, on 16 bytes."""
    return t.stride(3) == 1 and all(s % 8 == 0 for s in t.stride()[:3]) \
        and t.data_ptr() % 16 == 0


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.library("attention_train")
    if lib.attention_train_forward.argtypes is None:
        ll, ptr, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        lib.attention_train_forward.argtypes = (
            [ptr] * 5 + [i] * 7 + [ctypes.c_float] + [ll] * 9 + [ptr])
        lib.attention_train_backward.argtypes = (
            [ptr] * 10 + [i] * 7 + [ctypes.c_float] + [ll] * 12 + [ptr])
        lib.attention_train_forward.restype = i
        lib.attention_train_backward.restype = i
    return lib


def _check_card(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if any(is_fake(t) for t in (q, k, v)):
        raise ValueError("attention_train launches on CUDA memory, not on "
                         "fake tensors")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"attention_train runs bfloat16 on the card, not "
                         f"{q.dtype}")
    if q.shape[3] not in WIDTHS:
        raise ValueError(f"attention_train has no kernel for d={q.shape[3]}"
                         f" (instantiated: {WIDTHS})")
    if not all(_fits(t) for t in (q, k, v)):
        raise ValueError("attention_train needs d contiguous, the other "
                         "strides multiples of 8 and 16-byte aligned bases")
    if max(q.shape[0], q.shape[2]) > 65_535:
        raise ValueError(f"batch {q.shape[0]} or {q.shape[2]} heads exceed "
                         f"the grid's limit of 65535")


def launch_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_offset: int, scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on operands :func:`_check` and the card's checks
    passed: o (B, Sq, H, d) and lse (B, H, Sq)."""
    b, sq, h, d = q.shape
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = _lib().attention_train_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, sq, k.shape[1], h, k.shape[2], d, q_offset, scale,
        *_strides(q), *_strides(k), *_strides(v), _stream(q))
    if err != 0:
        raise RuntimeError(f"attention_train forward failed with CUDA error "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"offset {q_offset})")
    attention_train.launches += 1
    return o, lse


def launch_backward(q, k, v, o, lse, do, q_offset: int, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels (delta, dQ, dK and dV): dq, dk, dv."""
    if not _fits(do):
        do = do.contiguous()
    b, sq, h, d = q.shape
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    err = _lib().attention_train_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, sq, k.shape[1], h, k.shape[2], d, q_offset, scale,
        *_strides(q), *_strides(k), *_strides(v), *_strides(do), _stream(q))
    if err != 0:
        raise RuntimeError(f"attention_train backward failed with CUDA error "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"offset {q_offset})")
    attention_train.backward_launches += 1
    return dq, dk, dv


class _AttentionTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, q_offset: int, scale: float):
        if q.device.type == "cpu":
            o, lse = forward_plain(q, k, v, q_offset, scale)
        else:
            o, lse = launch_forward(q, k, v, q_offset, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.q_offset, ctx.scale = q_offset, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        run = backward_plain if q.device.type == "cpu" else launch_backward
        dq, dk, dv = run(q, k, v, o, lse, do, ctx.q_offset, ctx.scale)
        return dq, dk, dv, None, None


def attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: int = 0) -> torch.Tensor:
    """Causal attention of q (B, Sq, H, d) over k, v (B, Skv, KV, d), query
    i at position ``q_offset + i``, logits scaled by d ** -0.5; returns
    (B, Sq, H, d) in q's dtype, differentiable in q, k and v."""
    _check(q, k, v, q_offset)
    if q.device.type == "cuda":
        _check_card(q, k, v)
    elif q.device.type != "cpu":
        raise ValueError(f"attention_train runs on CUDA or CPU tensors, not "
                         f"{q.device}")
    return _AttentionTrain.apply(q, k, v, int(q_offset), q.shape[3] ** -0.5)


attention_train.launches = 0
attention_train.backward_launches = 0
