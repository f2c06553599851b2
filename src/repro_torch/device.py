"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card.  Without a card, asking for it raises:
    the port runs on the CPU only when the caller names ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def device_program(*host_params: str):
    """Mark a function as a device program: the port's counterpart of a
    ``jax.jit`` site, a plain function on tensors whose work is queued on
    the tensors' device.  ``host_params`` names the parameters it takes as
    host values (the jit site's ``static_argnames`` plus any parameter that
    is a plain Python value in the port); every other parameter is a tensor.

    The decorator returns the function itself, so no call gains a frame or
    an op.  Its arguments are read only by the linter
    (``repro_torch.analysis``, REP004 and REP009), which parses them."""
    def mark(fn):
        return fn
    return mark
