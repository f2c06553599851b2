"""Glue between the mapper/campaign layers and the ``repro_torch.dist``
device pool.

One resolution order everywhere a campaign chunk can be placed:

  1. an explicit ``GAConfig(devices=...)`` on the config in hand,
  2. the ``REPRO_DEVICES`` environment variable (count, ``"all"``, or
     comma-separated device indices — see
     ``repro_torch.dist.pool.parse_device_spec``),
  3. neither → ``None``: callers run every chunk on the call's own
     ``device``, the behavior without a pool.

Indices are CUDA ordinals on a CUDA call; a CPU call's pool is built over
the one CPU device.  Chunks are independent, so placement never changes
results — pooled and plain campaigns are bit-identical.
"""
from __future__ import annotations

from typing import Optional

from ..device import resolve_device
from ..dist.pool import DevicePool
from .envvars import get_env


def pool_for(cfg=None, device=None) -> Optional[DevicePool]:
    """The device pool requested by ``cfg.devices`` or ``REPRO_DEVICES``
    for a call on ``device`` (``None``: the CUDA card); ``None`` when
    neither asks for one (keep the call's device)."""
    spec = getattr(cfg, "devices", None) if cfg is not None else None
    if spec is None:
        spec = get_env("REPRO_DEVICES") or None
    if spec is None:
        return None
    return DevicePool.from_spec(spec, resolve_device(device))


def default_pool(device=None) -> Optional[DevicePool]:
    """The env-driven pool (``REPRO_DEVICES``) for call sites with no
    ``GAConfig`` in reach (fixed-genome replay, the torch flexion
    backend)."""
    return pool_for(None, device)
