"""Registry of every ``REPRO_*`` environment variable the PyTorch port reads.

The port keeps its own registry (the JAX package's is frozen and lists the
knobs of its benches and device pool, none of which the port reads yet).
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
