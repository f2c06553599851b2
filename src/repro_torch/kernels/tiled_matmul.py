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

import torch

from . import cast

ORDERS = ("out", "a", "b")
# Shared memory one block may use on an H100 (227 KB opt-in; CUDA C++
# Programming Guide, compute capability 9.0 technical specifications).
SMEM_LIMIT_BYTES = 232_448

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ORDER_CODE = {o: i for i, o in enumerate(ORDERS)}


def smem_bytes(bm: int, bn: int, bk: int, dtype_bytes: float = 2) -> float:
    """Dynamic shared memory one kernel block requests: the float32
    accumulator tile plus the x and y tiles at the operand width
    (``precision.bytes_of`` of the executed width)."""
    return bm * bn * 4 + (bm * bk + bk * bn) * dtype_bytes


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
    partial to the operand dtype and add in it (int8 wraps)."""
    bm, bn, bk = _check(x, y, bm, bn, bk, order)
    m, k = x.shape
    n = y.shape[1]
    if order == "out":
        acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
        for k0 in range(0, k, bk):
            acc += x[:, k0:k0 + bk].float() @ y[k0:k0 + bk, :].float()
        return cast(acc, x.dtype)
    out = torch.zeros((m, n), dtype=x.dtype, device=x.device)
    for k0 in range(0, k, bk):
        partial = x[:, k0:k0 + bk].float() @ y[k0:k0 + bk, :].float()
        out = out + cast(partial, x.dtype)
    return out


def _bind(lib: ctypes.CDLL):
    fn = lib.tiled_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
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

    launch = _bind(_build.library("tiled_matmul"))
    m, k = x.shape
    n = y.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = launch(_DTYPE_CODE[x.dtype], _ORDER_CODE[order], x.data_ptr(),
                 y.data_ptr(), out.data_ptr(), m, n, k, bm, bn, bk, stream)
    if err != 0:
        raise RuntimeError(f"tiled_matmul launch failed with CUDA error "
                           f"{err} (blocks {(bm, bn, bk)}, order {order!r},"
                           f" {x.dtype})")
    tiled_matmul.launches += 1
    return out


tiled_matmul.launches = 0
