"""The Mamba-1 selective scan of the model path: the hand-written Hopper
kernels of ``csrc/selective_scan_train.cu`` (a fused forward that keeps the
state in registers, and its deterministic backward) as one autograd op,
:func:`selective_scan`, beside its plain PyTorch version
:func:`scan_plain`.

    delta_t = softplus(delta_raw_t + delta_bias)
    h_t     = exp(delta_t (x) A) * h_{t-1} + (delta_t u_t) (x) B_t
    y_t     = (<h_t, C_t> + D u_t) * silu(z_t)

u, delta_raw and z are (batch, L, D), B and C (batch, L, N), A (D, N), D and
delta_bias (D,); every (batch, L, ...) operand is read in place through its
strides.  CPU tensors take the plain version in their own precision (float32,
or float64 for a gradient check); its backward recomputes the plain forward
under autograd.  CUDA tensors launch the kernels (u, delta_raw, z bfloat16;
B, C bfloat16 or float32; A, D, delta_bias float32; N in :data:`STATES`) or
raise, as fake tensors do.  Launches are counted in
``selective_scan.launches`` (forward) and ``selective_scan.backward_launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

# The state sizes csrc/selective_scan_train.cu instantiates: falcon-mamba-7b
# and its smoke size.
STATES = (16, 8)
# Positions a chunk: the forward saves the state at each chunk's end.
CHUNK = 16
LOG2E = 1.4426950408889634


def _check(u, delta, A, B, C, D, z, delta_bias) -> None:
    if u.dim() != 3 or delta.shape != u.shape or z.shape != u.shape:
        raise ValueError(f"need u, delta and z (batch, L, D) alike, got "
                         f"{tuple(u.shape)}, {tuple(delta.shape)}, "
                         f"{tuple(z.shape)}")
    b, length, d = u.shape
    if A.dim() != 2 or A.shape[0] != d:
        raise ValueError(f"need A (D, N) with D={d}, got {tuple(A.shape)}")
    n = A.shape[1]
    for name, t in (("B", B), ("C", C)):
        if tuple(t.shape) != (b, length, n):
            raise ValueError(f"need {name} (batch, L, N) = {(b, length, n)},"
                             f" got {tuple(t.shape)}")
    for name, t in (("D", D), ("delta_bias", delta_bias)):
        if tuple(t.shape) != (d,):
            raise ValueError(f"need {name} ({d},), got {tuple(t.shape)}")
    devices = {t.device for t in (u, delta, A, B, C, D, z, delta_bias)}
    if len(devices) != 1:
        raise ValueError(f"operands on {sorted(map(str, devices))}")


def scan_plain(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
               z: torch.Tensor, delta_bias: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic, one position at a time: softplus of delta
    plus its bias, the decay exp2(delta * (A * log2(e))), the state kept in
    float32 (float64 for float64 u), y rounded to u's dtype.
    Differentiable in every input."""
    f = torch.float64 if u.dtype == torch.float64 else torch.float32
    dt = F.softplus(delta.to(f) + delta_bias.to(f))           # (B, L, D)
    uf, bf, cf = u.to(f), B.to(f), C.to(f)
    a2 = A.to(f) * LOG2E
    h = torch.zeros(u.shape[0], u.shape[2], A.shape[1], dtype=f,
                    device=u.device)
    ys = []
    for t in range(u.shape[1]):
        h = torch.exp2(dt[:, t, :, None] * a2) * h \
            + (dt[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        ys.append((h * cf[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1) + D.to(f) * uf
    return (y * F.silu(z.to(f))).to(u.dtype)


def backward_plain(u, delta, A, B, C, D, z, delta_bias, dy
                   ) -> Tuple[torch.Tensor, ...]:
    """The gradients of :func:`scan_plain`'s y from dy, every input's (in
    its own dtype), by autograd through the recomputed plain forward."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in
               (u, delta, A, B, C, D, z, delta_bias)]
        y = scan_plain(*ins)
        return torch.autograd.grad(y, ins, dy)


def _strides(t: Optional[torch.Tensor]) -> Tuple[int, int, int]:
    return (0, 0, 0) if t is None else tuple(t.stride())


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _lib() -> ctypes.CDLL:
    from . import _build

    lib = _build.library("selective_scan_train")
    if lib.selective_scan_forward.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.selective_scan_forward.argtypes = (
            [ptr] * 10 + [i] * 5 + [ptr, ptr])
        lib.selective_scan_backward.argtypes = (
            [ptr] * 21 + [i] * 5 + [ptr, ptr])
        lib.selective_scan_forward.restype = i
        lib.selective_scan_backward.restype = i
        lib.selective_scan_blocks.argtypes = [i]
        lib.selective_scan_blocks.restype = i
    return lib


def _stride_array(*ts) -> ctypes.Array:
    vals = [s for t in ts for s in _strides(t)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _check_card(u, delta, A, B, C, D, z, delta_bias) -> None:
    ops = (u, delta, A, B, C, D, z, delta_bias)
    if any(is_fake(t) for t in ops):
        raise ValueError("selective_scan launches on CUDA memory, not on "
                         "fake tensors")
    if not u.dtype == delta.dtype == z.dtype == torch.bfloat16:
        raise ValueError(f"selective_scan runs u, delta and z in bfloat16 "
                         f"on the card, not {u.dtype}, {delta.dtype}, "
                         f"{z.dtype}")
    if B.dtype != C.dtype or B.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"selective_scan takes B and C both bfloat16 or "
                         f"both float32, not {B.dtype}, {C.dtype}")
    if not A.dtype == D.dtype == delta_bias.dtype == torch.float32:
        raise ValueError(f"selective_scan takes A, D and delta_bias in "
                         f"float32, not {A.dtype}, {D.dtype}, "
                         f"{delta_bias.dtype}")
    if A.shape[1] not in STATES:
        raise ValueError(f"selective_scan has no kernel for N={A.shape[1]} "
                         f"(instantiated: {STATES})")
    if u.shape[0] > 65_535:
        raise ValueError(f"batch {u.shape[0]} exceeds the grid's limit of "
                         f"65535")


def launch_forward(u, delta, A, B, C, D, z, delta_bias, save: bool
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The forward kernel on operands the checks passed: y (batch, L, D)
    and, with ``save``, the state at each chunk's end (batch, D,
    ceil(L / CHUNK), N) float32 for the backward."""
    b, length, d = u.shape
    n = A.shape[1]
    y = torch.empty((b, length, d), dtype=u.dtype, device=u.device)
    hsave = (torch.empty((b, d, -(-length // CHUNK), n),
                         dtype=torch.float32, device=u.device)
             if save else None)
    err = _lib().selective_scan_forward(
        u.data_ptr(), delta.data_ptr(), z.data_ptr(), B.data_ptr(),
        C.data_ptr(), A.data_ptr(), D.data_ptr(), delta_bias.data_ptr(),
        y.data_ptr(), None if hsave is None else hsave.data_ptr(),
        b, length, d, n, int(B.dtype == torch.float32),
        _stride_array(u, delta, z, B, C, None), _stream(u))
    if err != 0:
        raise RuntimeError(f"selective_scan forward failed with CUDA error "
                           f"{err} (u {tuple(u.shape)}, N {n})")
    selective_scan.launches += 1
    return y, hsave


def launch_backward(u, delta, A, B, C, D, z, delta_bias, hsave, dy
                    ) -> Tuple[torch.Tensor, ...]:
    """The backward kernels: du, ddelta, dA, dB, dC, dD, dz, ddelta_bias,
    each in its input's dtype."""
    b, length, d = u.shape
    n = A.shape[1]
    lib = _lib()
    dev = u.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    du, ddelta, dz = (torch.empty((b, length, d), dtype=t.dtype, device=dev)
                      for t in (u, delta, z))
    part_bc = f32(lib.selective_scan_blocks(d), 2, b, length, n)
    part_a, part_d, part_bias = f32(b, d, n), f32(b, d), f32(b, d)
    dbc, da, dd, dbias = f32(2, b, length, n), f32(d, n), f32(d), f32(d)
    err = lib.selective_scan_backward(
        u.data_ptr(), delta.data_ptr(), z.data_ptr(), B.data_ptr(),
        C.data_ptr(), A.data_ptr(), D.data_ptr(), delta_bias.data_ptr(),
        hsave.data_ptr(), dy.data_ptr(), du.data_ptr(), ddelta.data_ptr(),
        dz.data_ptr(), part_bc.data_ptr(), part_a.data_ptr(),
        part_d.data_ptr(), part_bias.data_ptr(), dbc.data_ptr(),
        da.data_ptr(), dd.data_ptr(), dbias.data_ptr(),
        b, length, d, n, int(B.dtype == torch.float32),
        _stride_array(u, delta, z, B, C, dy), _stream(u))
    if err != 0:
        raise RuntimeError(f"selective_scan backward failed with CUDA error "
                           f"{err} (u {tuple(u.shape)}, N {n})")
    selective_scan.backward_launches += 1
    return (du, ddelta, da, dbc[0].to(B.dtype), dbc[1].to(C.dtype), dd, dz,
            dbias)


class _SelectiveScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, delta_bias):
        ops = (u, delta, A, B, C, D, z, delta_bias)
        if u.device.type == "cpu":
            y, hsave = scan_plain(*ops), None
        else:
            y, hsave = launch_forward(*ops,
                                      save=any(ctx.needs_input_grad))
        ctx.save_for_backward(*ops, hsave)
        return y

    @staticmethod
    def backward(ctx, dy):
        *ops, hsave = ctx.saved_tensors
        if ops[0].device.type == "cpu":
            return backward_plain(*ops, dy)
        return launch_backward(*ops, hsave, dy)


def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   z: torch.Tensor, delta_bias: torch.Tensor) -> torch.Tensor:
    """y (batch, L, D) in u's dtype (module docstring), differentiable in
    every input."""
    _check(u, delta, A, B, C, D, z, delta_bias)
    if u.device.type == "cuda":
        _check_card(u, delta, A, B, C, D, z, delta_bias)
        A, D, delta_bias = (t.contiguous() for t in (A, D, delta_bias))
    elif u.device.type != "cpu":
        raise ValueError(f"selective_scan runs on CUDA or CPU tensors, not "
                         f"{u.device}")
    return _SelectiveScan.apply(u, delta, A, B, C, D, z, delta_bias)


selective_scan.launches = 0
selective_scan.backward_launches = 0
