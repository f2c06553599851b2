"""Plain PyTorch oracles (the ground truth in kernel tests)."""
from __future__ import annotations

import torch

from . import cast


def matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """float32 product over all of K, then one (saturating) cast back to
    the operand dtype."""
    return cast(torch.matmul(x.float(), y.float()), x.dtype)
