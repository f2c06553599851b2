"""Mesh construction, the counterpart of ``repro/launch/mesh.py`` on
``torch.distributed``.

A mesh is a ``DeviceMesh`` over the ranks of the default process group
(``torchrun`` sets one up; so can ``torch.distributed.init_process_group``).
Each rank drives one device: the CUDA card unless the caller asks for the
CPU.  Single pod: 16x16 = 256 ranks ('data', 'model'); multi-pod: 2x16x16
= 512 ranks ('pod', 'data', 'model'), the 'pod' axis composing with 'data'
for batch/FSDP sharding.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple


def _device_type(device_type: Optional[str]) -> str:
    from ..device import resolve_device
    return resolve_device(device_type).type


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default process
    group, whose world size must be the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a process group of {math.prod(shape)} "
            f"ranks: launch under torchrun, or call "
            f"torch.distributed.init_process_group first")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; "
                         f"the process group has {dist.get_world_size()}")
    return init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def mesh_axis_size(mesh, name: str) -> int:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))).get(name, 1)


def dp_degree(mesh) -> int:
    return mesh_axis_size(mesh, "pod") * mesh_axis_size(mesh, "data")
