"""Carry the JAX package's state into the port's types.

Every function takes plain data — ``dataclasses.asdict(obj)`` of the
reference object, or a numpy array — so the port never imports the
reference; a test builds the reference object, converts it here, and both
packages then rate the same accelerator, layer and genome.  Model params
travel the same way: the reference's ``init_params`` tree after
``jax.tree.map(np.asarray, ...)``, or a tree drawn by numpy from a seed
(``numpy_params``), maps onto the port's params leaf by leaf.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from .flexion import FlexionReport
from .kernel_bridge import KernelConfig
from .mapspace import Mapping
from .spec import (FlexSpec, HWConfig, OrderSpec, ParallelSpec,
                   RepresentationSpec, ShapeSpec, TileSpec)
from .workloads import Layer

if TYPE_CHECKING:
    from ..models.config import ModelConfig


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


def kernel_config_from_dict(d: dict) -> KernelConfig:
    return KernelConfig(kind=d["kind"],
                        block=tuple(int(v) for v in d["block"]),
                        order=d["order"], bits=int(d["bits"]))


def flexion_report_from_dict(d: dict) -> FlexionReport:
    return FlexionReport(per_axis_hf=dict(d["per_axis_hf"]),
                         per_axis_wf=dict(d["per_axis_wf"]),
                         hf=float(d["hf"]), wf=float(d["wf"]),
                         mc_samples=int(d["mc_samples"]))


def _fill(skeleton, tree, device, path: str):
    if isinstance(skeleton, dict):
        if not isinstance(tree, dict) or set(tree) != set(skeleton):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"params{path}: keys {got}, expected "
                             f"{sorted(skeleton)}")
        return {k: _fill(skeleton[k], tree[k], device, f"{path}/{k}")
                for k in skeleton}
    a = np.array(tree, dtype=np.float32)       # bfloat16 leaves widen here
    if a.shape != tuple(skeleton.shape):
        raise ValueError(f"params{path}: shape {a.shape}, expected "
                         f"{tuple(skeleton.shape)}")
    return torch.from_numpy(a).to(device=device, dtype=skeleton.dtype)


def params_from_numpy(cfg: ModelConfig, tree: Dict, device=None) -> Dict:
    """A params tree of numpy arrays in the reference's layout (names,
    stacked layer axis) as the port's params on ``device``, each leaf in
    the dtype the port's ``init_params`` gives it.  Raises on a missing or
    extra leaf and on a shape mismatch."""
    from ..models.model import init_params     # core needs no model stack
    skeleton = init_params(cfg, None, "meta")
    return _fill(skeleton, tree, resolve_device(device), "")


# leaves drawn around 1 (norm scales, the skip gain D) and around 0 (biases)
_NEAR_ONE = ("ln1", "ln2", "ln_x", "ln_f", "ln_enc", "scale", "D")
_NEAR_ZERO = ("bias", "conv_b", "dt_bias")


def numpy_params(cfg: ModelConfig, seed: int) -> Dict:
    """A params tree in the reference's layout drawn by numpy from ``seed``
    (float32): weights normal at 1/sqrt(fan-in) (the embedding at
    1/sqrt(d_model), the conv taps at 0.1), norm scales and D at 1 ± 0.1,
    biases at 0 ± 0.1, A_log at log(1..N) ± 0.1.  Unlike the reference's
    init the norms and biases are not constant, so a check on this tree
    also covers them.  Leaves are drawn in sorted key order."""
    from ..models.model import init_params
    rng = np.random.default_rng(seed)

    def draw(node, name):
        if isinstance(node, dict):
            return {k: draw(node[k], k) for k in sorted(node)}
        shape = tuple(node.shape)
        z = rng.standard_normal(shape)
        if name == "A_log":
            v = np.log(np.arange(1, shape[-1] + 1)) + 0.1 * z
        elif name in _NEAR_ONE:
            v = 1.0 + 0.1 * z
        elif name in _NEAR_ZERO:
            v = 0.1 * z
        elif name == "conv_w":
            v = 0.1 * z
        elif name == "embed":
            v = z * shape[-1] ** -0.5
        else:
            v = z * shape[-2] ** -0.5
        return v.astype(np.float32)

    return draw(init_params(cfg, None, "meta"), "")
