"""Device pool: shard independent work items (campaign chunks) over devices.

The campaign layers (``repro_torch.core.engine``, the fixed-genome replay,
the torch flexion backend) produce streams of *independent* chunks — no
chunk reads another's output, so WHERE a chunk executes is pure
scheduling.  This module is the ``repro_torch.dist`` face of that freedom:

  * :class:`DevicePool` — an ordered set of ``torch.device``\\ s with
    round-robin chunk→device assignment (``device_for``) and tensor
    placement (``place``);
  * :func:`parse_device_spec` — one grammar for every entry point
    (``GAConfig(devices=...)``, the ``REPRO_DEVICES`` env var, bench
    arguments);
  * :class:`InFlightQueue` — a bounded FIFO of dispatched-but-uncollected
    chunks, generalizing a single software-pipeline slot to one slot per
    device.

Chunks stay bit-identical wherever they run (each chunk's inputs and ops
are unchanged; only the device its tensors live on differs), which is
what makes the sharded campaign's golden-parity guarantee possible.

The pool is *local*: on a CUDA call it spreads chunks over the CUDA
ordinals of this process (``torch.cuda.device_count()``); on a CPU call it
is built over the one CPU device.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DeviceSpec = Union[None, int, str, Sequence[int]]


def parse_device_spec(spec: DeviceSpec) -> Optional[Tuple[int, ...]]:
    """Normalize a device request to a tuple of local-device indices.

    Accepted forms (the same grammar everywhere a pool can be requested):

      * ``None`` / ``""``  — no explicit request (callers keep the call's
        own device);
      * ``int`` / ``"4"``  — the first N local devices (clamped to what the
        platform actually has, so ``REPRO_DEVICES=4`` is safe on a
        single-card host);
      * ``"all"``          — every local device;
      * ``"0,2"`` / ``(0, 2)`` — explicit local-device indices.  Duplicates
        are kept deliberately: ``(0, 0)`` is a depth-2 pipeline on one
        device.

    Counts/indices are validated here (``ValueError`` on a non-positive
    count or a negative index); existence of an explicit index is checked
    against the live platform in :meth:`DevicePool.from_spec`.
    """
    if spec is None:
        return None
    if isinstance(spec, str):
        spec = spec.strip()
        if not spec:
            return None
        if spec.lower() == "all":
            return ()          # empty tuple = "every local device"
        if "," in spec:
            spec = [int(p) for p in spec.split(",") if p.strip()]
        else:
            spec = int(spec)
    if isinstance(spec, bool):
        raise ValueError(f"invalid device spec {spec!r}")
    if isinstance(spec, int):
        if spec < 1:
            raise ValueError(f"device count must be >= 1, got {spec}")
        return tuple(range(spec))
    idx = tuple(int(i) for i in spec)
    if not idx:
        raise ValueError("explicit device index list must not be empty")
    if any(i < 0 for i in idx):
        raise ValueError(f"device indices must be >= 0, got {idx}")
    return idx


class DevicePool:
    """An ordered pool of torch devices; work item *i* runs on device
    ``i % len(pool)``."""

    def __init__(self, devices: Sequence):
        devices = tuple(devices)
        if not devices:
            raise ValueError("DevicePool needs at least one device")
        self.devices = devices

    @classmethod
    def from_spec(cls, spec: DeviceSpec, device: torch.device
                  ) -> Optional["DevicePool"]:
        """Build a pool from :func:`parse_device_spec` output against the
        devices of ``device``'s type — every CUDA ordinal for a CUDA call,
        the one CPU device for a CPU call; ``None`` spec means "no pool"
        (the call's own device).

        A count larger than the platform clamps to every local device; an
        *explicit* out-of-range index is an error (the caller named a device
        that does not exist)."""
        idx = parse_device_spec(spec)
        if idx is None:
            return None
        device = torch.device(device)
        if device.type == "cuda":
            local = [torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())]
        else:
            local = [torch.device(device.type)]
        if idx == ():                       # "all"
            return cls(local)
        if isinstance(spec, int) or (isinstance(spec, str)
                                     and "," not in spec
                                     and spec.strip().lower() != "all"):
            # count form: clamp to availability
            return cls(local[:max(1, min(len(idx), len(local)))])
        missing = [i for i in idx if i >= len(local)]
        if missing:
            raise ValueError(
                f"device indices {missing} out of range: only "
                f"{len(local)} local {local[0].type} device(s) present")
        return cls([local[i] for i in idx])

    def __len__(self) -> int:
        return len(self.devices)

    def device_for(self, index: int) -> torch.device:
        """Round-robin device for the ``index``-th work item."""
        return self.devices[index % len(self.devices)]

    def place(self, tree, index: int):
        """Move every array of ``tree`` (numpy arrays and tensors inside
        nested tuples and lists, NamedTuples included) onto
        ``device_for(index)`` as tensors."""
        return _place(tree, self.device_for(index))


def _place(tree, device: torch.device):
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return torch.as_tensor(tree, device=device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_place(t, device) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_place(t, device) for t in tree)
    return tree


class InFlightQueue:
    """Bounded FIFO of dispatched chunks awaiting collection.

    ``push`` registers a dispatched chunk and — once more than ``depth``
    chunks are in flight — collects (blocks on) the oldest first, returning
    its results; ``drain`` collects everything left, oldest first.  With
    ``depth = len(pool)`` and round-robin dispatch, chunk *i* is collected
    exactly when chunk *i + depth* needs its device back: one in-flight
    chunk per device, results in submission order.

    ``collect`` is the materializer (e.g. the engine's ``_collect_chunk``);
    each queue entry is the argument tuple it will be called with.
    """

    def __init__(self, depth: int, collect: Callable[..., List]):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        self.depth = depth
        self._collect = collect
        self._q: deque = deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, *entry) -> List:
        """Add a dispatched chunk; returns the collected results of any
        chunk evicted to respect the depth bound (possibly empty).

        The entry is registered BEFORE the eviction collects — if a collect
        raises, the just-dispatched chunk is already in the queue, so an
        error-path ``drain`` still reaches it (nothing dispatched is ever
        abandoned)."""
        self._q.append(entry)
        out: List = []
        while len(self._q) > self.depth:
            out.extend(self._collect(*self._q.popleft()))
        return out

    def drain(self) -> List:
        """Collect every in-flight chunk, oldest first."""
        out: List = []
        while self._q:
            out.extend(self._collect(*self._q.popleft()))
        return out
