"""Logical-axis sharding API, the counterpart of ``repro/dist/api.py`` on a
``torch.distributed`` ``DeviceMesh``.

Model code never names mesh axes.  It annotates tensors with *logical*
axis names — ``("batch", "seq", None)`` — and a rule table (bound per
launch by ``axis_rules``) maps each logical name to zero or more *mesh*
axes.  Outside an ``axis_rules`` context every annotation is a no-op, so
the same model code runs unsharded on one device and sharded, as
``DTensor``s, over a mesh:

    with axis_rules(mesh, make_rules(mesh, fsdp=True)):
        state, metrics = train_step(state, batch)   # constrain() binds

A mesh here is anything with ``mesh_dim_names`` and ``shape`` (a
``DeviceMesh``, or a shape-only stand-in for the spec tables).  The
reference's ``PartitionSpec`` and ``NamedSharding`` have small
counterparts: :class:`PartitionSpec` (``P``), a tuple of per-dimension
entries, and :class:`NamedSharding`, a (mesh, spec) pair whose
``placements`` are the ``Shard``/``Replicate`` list a ``DTensor`` takes.
``constrain`` redistributes a ``DTensor`` to its resolved spec (the
reference's ``with_sharding_constraint``).

``validate_spec`` is the safety valve: per dimension it keeps the longest
prefix of mesh axes that exist on the mesh, are unused by earlier
dimensions, and divide the dimension.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

# A rule maps a logical axis name to: None (replicate), one mesh axis name,
# or a tuple of mesh axis names (sharded over their product, major first).
RuleValue = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, RuleValue]


class PartitionSpec(tuple):
    """Per-dimension mesh axes: ``None``, a mesh axis name, or a tuple of
    names.  A one-name tuple is stored as the name, so equality is the
    reference's (``P(("data",)) == P("data")``, ``P(None) != P()``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_sizes(mesh) -> Dict[str, int]:
    """Mesh axis name -> size."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def spec_to_placements(spec: Sequence, mesh) -> List:
    """One ``Shard(d)`` / ``Replicate()`` per mesh dimension.  A tensor
    dimension sharded over several mesh axes takes them in mesh order,
    major first, as JAX shards a tuple entry; DTensor expresses no other
    order, so a tuple that does not follow the mesh raises.  A mesh axis
    of size 1 holds every index on its one rank, so it replicates: a spec
    keeps it (as the reference's does), but its placement is
    ``Replicate()``, which no DTensor view or reshape rule refuses."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    placements: List = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(ax) for ax in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} does not follow the mesh "
                             f"order {tuple(names)}")
        for i in idx:
            if sizes[names[i]] > 1:
                placements[i] = Shard(d)
    return placements


class NamedSharding:
    """A (mesh, spec) pair, the reference's ``NamedSharding``."""

    def __init__(self, mesh, spec: Sequence = ()):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    @property
    def placements(self) -> List:
        return spec_to_placements(self.spec, self.mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({tuple(self.mesh.mesh_dim_names)}, " \
               f"{self.spec!r})"


_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


@contextlib.contextmanager
def axis_rules(mesh, rules: Rules):
    """Bind (mesh, rules) for the dynamic extent of the block.  Nesting is
    allowed; the innermost binding wins.  The binding is per thread."""
    _stack().append((mesh, dict(rules)))
    try:
        yield
    finally:
        _stack().pop()


def current_rules() -> Optional[Tuple[object, Rules]]:
    """The innermost active (mesh, rules) binding, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def logical_to_spec(logical_axes: Sequence[Optional[str]], rules: Rules
                    ) -> PartitionSpec:
    """Resolve logical axis names through a rule table to a spec.  ``None``
    entries and names without a rule resolve to None (replicated)."""
    return P(*(rules.get(name) if name is not None else None
               for name in logical_axes))


def validate_spec(spec: Sequence, shape: Sequence[int], mesh
                  ) -> PartitionSpec:
    """Repair a spec against a mesh and a tensor shape.

    Per dimension, mesh axes are kept as the longest prefix such that every
    kept axis (a) exists on the mesh, (b) is not already sharding an
    earlier dimension, and (c) the cumulative axis-size product divides the
    dimension.  Size-1 mesh axes always divide.  Tuple entries stay tuples
    (their kept prefix), names stay names or drop to None; entries past the
    tensor's rank are cut."""
    sizes = mesh_sizes(mesh)
    used: set = set()
    entries = []
    for dim, entry in zip(tuple(shape), tuple(spec)):
        if entry is None:
            entries.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept = []
        prod = 1
        for ax in axes:
            if ax not in sizes or ax in used or dim % (prod * sizes[ax]):
                break
            kept.append(ax)
            prod *= sizes[ax]
            used.add(ax)
        if not kept:
            entries.append(None)
        elif isinstance(entry, tuple):
            entries.append(tuple(kept))
        else:
            entries.append(kept[0])
    return P(*entries)


def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False     # the one-device path never imports DTensor
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_start(mesh, mesh_dims: Sequence[int], size: int) -> int:
    """The first global index of this rank's even shard, ``size`` long, of
    a dim split over the mesh dims ``mesh_dims`` (mesh order, major
    first)."""
    coord = mesh.get_coordinate()
    chunk = 0
    for i in mesh_dims:
        chunk = chunk * mesh.size(i) + coord[i]
    return chunk * size


def unshard_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with no mesh axis sharding ``dim`` (``x`` itself when it is
    not a ``DTensor`` or nothing shards it), for the ops that DTensor runs
    only along whole dimensions (``unbind``, ``gather``)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    dim = dim % x.dim()
    placements = [Replicate() if getattr(p, "dim", None) == dim else p
                  for p in x.placements]
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """Annotate ``x`` with logical axes; a no-op outside ``axis_rules`` and
    for a tensor that is not a ``DTensor``.  Inside a binding, resolves the
    names through the active rules, repairs the spec for the active mesh,
    and redistributes ``x`` to it."""
    ctx = current_rules()
    if ctx is None or not is_dtensor(x):
        return x
    mesh, rules = ctx
    spec = logical_to_spec(tuple(logical_axes), rules)
    spec = validate_spec(spec, x.shape, mesh)
    placements = spec_to_placements(spec, mesh)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)
