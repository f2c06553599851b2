"""Registry of every ``REPRO_*`` environment variable the PyTorch port reads.

The port keeps its own registry (the JAX package's is frozen and lists the
knobs of its benches; the port's benches take their mode, path, device
pool and client count as arguments instead).
``get_env`` is the accessor every call site uses; an unregistered name
raises, so a mistyped knob fails at the read site.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

__all__ = ["EnvVar", "REGISTRY", "get_env"]


@dataclasses.dataclass(frozen=True)
class EnvVar:
    name: str
    kind: str                    # "choice" | "flag" | "int" | "path" | "spec"
    default: str                 # behavior when unset, as rendered in docs
    description: str
    consumers: Tuple[str, ...]   # modules that read it


REGISTRY: Tuple[EnvVar, ...] = (
    EnvVar(
        "REPRO_NO_KERNELS", "flag", "off",
        "Kernel-bridge autotuning falls back to the modeled objective "
        "instead of timing the hand-written kernels.",
        ("repro_torch.core.kernel_bridge",)),
    EnvVar(
        "REPRO_FLEXION_BACKEND", "choice", "by device",
        "Backend of the flexion T-axis predicates: `numpy` (float64 on the "
        "host) or `torch` (float32 on the caller's device).  Unset: torch "
        "on a CUDA device, numpy on the CPU.",
        ("repro_torch.core.flexion_batched",)),
    EnvVar(
        "REPRO_DEVICES", "spec: count / 'all' / i,j,...", "unset",
        "Device pool for campaign chunks when the GAConfig does not name "
        "one (see repro_torch.dist.pool.parse_device_spec): CUDA ordinals "
        "on a CUDA call, the one CPU device on a CPU call.  Unset: every "
        "chunk runs on the call's own device.",
        ("repro_torch.core.device_pool",)),
)

_BY_NAME = {v.name: v for v in REGISTRY}


def get_env(name: str, default: Optional[str] = None) -> Optional[str]:
    """The one accessor for ``REPRO_*`` knobs.  Unregistered names raise
    KeyError so a typo'd knob fails loudly at the read site instead of
    silently falling back to the default forever."""
    if name not in _BY_NAME:
        raise KeyError(
            f"{name!r} is not in repro_torch.core.envvars.REGISTRY — "
            f"register it before reading")
    return os.environ.get(name, default)
