"""Public entry points for the kernels.

A CUDA tensor runs the hand-written kernel; a CPU tensor runs its plain
PyTorch version.  ``use_kernel=False`` gives the oracle in ``ref`` instead
(the counterpart of the JAX package's ``use_pallas=False``).
"""
from __future__ import annotations

from . import cast, dtype_for_bits, ref
from .flash_attention import flash_attention, flash_attention_bshd
from .mamba_scan import mamba_scan as _mamba_scan
from .tiled_matmul import tiled_matmul


def _cast(arrays, bits, kind):
    """R-axis width threading: ``bits`` (a mapper ``Mapping.repr_bits``)
    selects the executed kernel dtype; ``None`` keeps the caller's dtypes.
    Float -> int8 saturates, as in the JAX package."""
    if bits is None:
        return arrays
    dt = dtype_for_bits(bits, kind)
    return tuple(cast(a, dt) for a in arrays)


def matmul(x, y, *, bm=128, bn=128, bk=128, order="out", bits=None,
           use_kernel=True):
    x, y = _cast((x, y), bits, "matmul")
    if not use_kernel:
        return ref.matmul_ref(x, y)
    return tiled_matmul(x, y, bm=bm, bn=bn, bk=bk, order=order)


def attention(q, k, v, *, causal=True, bq=256, bkv=256, bits=None,
              use_kernel=True):
    q, k, v = _cast((q, k, v), bits, "attention")
    if not use_kernel:
        return ref.attention_ref(q, k, v, causal=causal)
    return flash_attention(q, k, v, causal=causal, bq=bq, bkv=bkv)


def attention_bshd(q, k, v, *, causal=True, bq=256, bkv=256,
                   use_kernel=True):
    if not use_kernel:
        group = q.shape[2] // k.shape[2]
        kk = k.repeat_interleave(group, dim=2).permute(0, 2, 1, 3)
        vv = v.repeat_interleave(group, dim=2).permute(0, 2, 1, 3)
        qq = q.permute(0, 2, 1, 3)
        b, hh, sq, d = qq.shape
        o = ref.attention_ref(qq.reshape(b * hh, sq, d),
                              kk.reshape(b * hh, -1, d),
                              vv.reshape(b * hh, -1, d), causal=causal)
        return o.reshape(b, hh, sq, d).permute(0, 2, 1, 3)
    return flash_attention_bshd(q, k, v, causal=causal, bq=bq, bkv=bkv)


def mamba_scan(x, dt, b, c, a_log_neg, d_skip, *, chunk=128, d_block=512,
               bits=None, use_kernel=True):
    x, dt, b, c = _cast((x, dt, b, c), bits, "mamba")
    if not use_kernel:
        return ref.mamba_scan_ref(x, dt, b, c, a_log_neg, d_skip)
    return _mamba_scan(x, dt, b, c, a_log_neg, d_skip, chunk=chunk,
                       d_block=d_block)
