"""Public entry points for the kernels.

A CUDA tensor runs the hand-written kernel; a CPU tensor runs its plain
PyTorch version.  ``use_kernel=False`` gives the oracle in ``ref`` instead
(the counterpart of the JAX package's ``use_pallas=False``).
"""
from __future__ import annotations

from . import cast, dtype_for_bits, ref
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
