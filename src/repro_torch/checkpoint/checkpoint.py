"""Partitioned, async, elastic checkpointing, the counterpart of
``repro/checkpoint/checkpoint.py`` on the reference's on-disk layout.

* Partitioned: one ``.npy`` per leaf plus a JSON manifest (names, shapes,
  dtypes, step) in ``step_<N>/``.  Leaves are numbered in the order JAX
  flattens the same tree (``repro_torch.tree``), so ``leaf_<i>`` is the
  same leaf in a checkpoint of either package.  numpy has no bfloat16: a
  bfloat16 leaf is written as the reference writes it, raw 2-byte ``<V2``
  records with ``"dtype": "bfloat16"`` in the manifest.
* Async: ``save`` takes host copies of every leaf before it returns and
  writes them on a background thread, so the train loop goes on updating
  its tensors in place (``wait()`` joins before the next save or exit).
* Elastic: ``restore_state`` puts every leaf on the device it is given, or
  with ``shardings`` distributes it onto a mesh as a ``DTensor``; a
  checkpoint written from one device or mesh restores onto any other.
  A state of ``DTensor``s is saved whole: every rank gathers each leaf
  (a collective) and rank 0 writes it, so the files are the ones a
  one-device save of the same state writes, byte for byte.
* Atomic: writes go to ``step_<N>.tmp``, renamed on completion; partial
  checkpoints are never visible.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..dist.api import is_dtensor
from ..tree import named_leaves, unflatten

# numpy's names of the dtypes a state holds (the manifest's "dtype")
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
          torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}


def _host_copy(x: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``x`` that later writes to ``x`` cannot reach, and
    its dtype's name; bfloat16 as its 16-bit patterns."""
    if is_dtensor(x):
        x = x.full_tensor()
    host = x.detach().to("cpu", copy=True)
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy(), "bfloat16"
    return host.numpy(), _NAMES[host.dtype]


def _write_leaf(path: str, a: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, a)
        return
    # the header ml_dtypes' bfloat16 gives np.save: '<V2' records
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
        f.write(np.ascontiguousarray(a).tobytes())


def _read_leaf(path: str, dtype: str) -> torch.Tensor:
    a = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _writer(state) -> bool:
    """Whether this process writes ``state``: always, unless the state is
    distributed and this is not rank 0."""
    if not any(is_dtensor(x) for _, x in named_leaves(state)):
        return True
    import torch.distributed as dist
    return dist.get_rank() == 0


def save_state(ckpt_dir: str, step: int, state, blocking: bool = True
               ) -> Optional[threading.Thread]:
    """Write ``state`` as ``step_<step>/`` under ``ckpt_dir``; with
    ``blocking=False`` on a background thread, which is returned.  Every
    rank of a distributed state calls it; rank 0 writes."""
    # host copies first: the device-to-host snapshot (gathered if sharded)
    host = [(n, *_host_copy(x)) for n, x in named_leaves(state)]
    if not _writer(state):
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step,
                "leaves": [{"name": n, "shape": list(a.shape),
                            "dtype": dt} for n, a, dt in host]}

    def write():
        for i, (_, a, dt) in enumerate(host):
            _write_leaf(os.path.join(tmp, f"leaf_{i}.npy"), a, dt)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if blocking:
        write()
        return None
    th = threading.Thread(target=write, daemon=True)
    th.start()
    return th


def _steps(ckpt_dir: str) -> List[int]:
    return [int(m.group(1)) for d in os.listdir(ckpt_dir)
            if (m := re.fullmatch(r"step_(\d+)", d))]


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [s for s in _steps(ckpt_dir) if os.path.exists(
        os.path.join(ckpt_dir, f"step_{s}", "manifest.json"))]
    return max(steps) if steps else None


def restore_state(ckpt_dir: str, step: int, abstract_state, device=None,
                  shardings=None):
    """The checkpoint of ``step`` in ``abstract_state``'s structure, each
    leaf in the dtype of its counterpart there (tensors, ``meta`` ones
    included, give shape and dtype) and on ``device`` (the CUDA card
    unless the caller names another).  With ``shardings`` (a tree of
    ``NamedSharding``s of the same structure) every rank reads each whole
    leaf on the host and copies only its own shard of it to the device:
    the state comes back as ``DTensor``s on the target mesh, whatever mesh
    wrote it, and no rank ever holds more than its share."""
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    named = named_leaves(abstract_state)
    if len(named) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"state expects {len(named)}")
    if shardings is not None:
        from ..dist.sharding import distribute_host
        shs = [sh for _, sh in named_leaves(shardings)]
        if len(shs) != len(named):
            raise ValueError(f"{len(shs)} shardings, {len(named)} leaves")
    leaves = []
    for i, ((name, spec), meta) in enumerate(zip(named, manifest["leaves"])):
        a = _read_leaf(os.path.join(path, f"leaf_{i}.npy"), meta["dtype"])
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"{name}: ckpt shape {tuple(a.shape)} != "
                             f"expected {tuple(spec.shape)}")
        leaves.append(a.to(device=dev, dtype=spec.dtype) if shardings is None
                      else distribute_host(a, shs[i], dev, spec.dtype))
    return unflatten(abstract_state, leaves)


class CheckpointManager:
    """Keep-latest-k manager with async writes."""

    def __init__(self, ckpt_dir: str, keep: int = 3, async_write: bool = True):
        self.dir = ckpt_dir
        self.keep = keep
        self.async_write = async_write
        self._pending: Optional[threading.Thread] = None
        self._sharded = False   # the last save was of a distributed state

    def save(self, step: int, state):
        self.wait()
        self._sharded = any(is_dtensor(x) for _, x in named_leaves(state))
        if _writer(state):
            self._gc(incoming=1)  # leave room for the one being written
        self._pending = save_state(self.dir, step, state,
                                   blocking=not self.async_write)

    def wait(self):
        """Join the pending write; after a distributed save every rank
        then waits for rank 0's, so all of them see the same files."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._sharded:
            import torch.distributed as dist
            dist.barrier()
            self._sharded = False

    def latest(self) -> Optional[int]:
        return latest_step(self.dir)

    def restore(self, abstract_state, device=None, step=None,
                shardings=None):
        self.wait()
        step = step if step is not None else self.latest()
        if step is None:
            return None, None
        return restore_state(self.dir, step, abstract_state, device,
                             shardings), step

    def _gc(self, incoming: int = 0):
        if not os.path.isdir(self.dir):
            return
        budget = max(self.keep - incoming, 1)
        for s in sorted(_steps(self.dir))[:-budget]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
