"""Carry the JAX package's state into the port's types.

Every function takes plain data — ``dataclasses.asdict(obj)`` of the
reference object, or a numpy array — so the port never imports the
reference; a test builds the reference object, converts it here, and both
packages then rate the same accelerator, layer and genome.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .mapspace import Mapping
from .spec import (FlexSpec, HWConfig, OrderSpec, ParallelSpec,
                   RepresentationSpec, ShapeSpec, TileSpec)
from .workloads import Layer


def _tuples(v):
    """asdict keeps tuples, but data that went through JSON holds lists."""
    if isinstance(v, (list, tuple)):
        return tuple(_tuples(x) for x in v)
    return v


def _fields(d: dict) -> dict:
    return {k: _tuples(v) for k, v in d.items()}


def hw_from_dict(d: dict) -> HWConfig:
    return HWConfig(**_fields(d))


def spec_from_dict(d: dict) -> FlexSpec:
    return FlexSpec(
        name=d["name"], hw=hw_from_dict(d["hw"]),
        tile=TileSpec(**_fields(d["tile"])),
        order=OrderSpec(**_fields(d["order"])),
        parallel=ParallelSpec(**_fields(d["parallel"])),
        shape=ShapeSpec(**_fields(d["shape"])),
        representation=RepresentationSpec(**_fields(d["representation"])))


def layer_from_dict(d: dict) -> Layer:
    return Layer(name=d["name"], dims=tuple(int(v) for v in d["dims"]),
                 stride=int(d["stride"]), depthwise=bool(d["depthwise"]))


def mapping_from_dict(d: dict) -> Mapping:
    return Mapping(tiles=tuple(int(v) for v in d["tiles"]),
                   order=tuple(int(v) for v in d["order"]),
                   parallel=tuple(int(v) for v in d["parallel"]),
                   shape=tuple(int(v) for v in d["shape"]),
                   repr_bits=int(d["repr_bits"]))


def genomes_from_numpy(a, device: Optional[torch.device] = None):
    """Genomes ``(..., 10)`` as int32: a numpy array, or a tensor on
    ``device`` when one is given."""
    g = np.asarray(a)
    if g.shape[-1:] != (10,):
        raise ValueError(f"genomes must end in 10 genes, got {g.shape}")
    g = g.astype(np.int32)
    return g if device is None else torch.as_tensor(g, device=device)
