"""Rule tables and sharding factories for the production meshes, the
counterpart of ``repro/dist/sharding.py``.

``DEFAULT_RULES`` is written for the full multi-pod mesh
('pod', 'data', 'model'); ``make_rules`` specializes it to whatever mesh is
in hand by dropping absent axes, then layers on the launch-time knobs
(FSDP, Megatron-SP activations, long-context cache sharding).

Factories:
  batch_spec       -> callable mapping a tensor (or anything with a shape)
                      to a NamedSharding (dim 0 over the batch axes)
  param_shardings  -> NamedSharding tree mirroring a param tree leaf for leaf
  cache_shardings  -> NamedSharding tree for decode caches (KV / SSM state)

Leaves are matched by their names in the tree (``repro_torch.tree``), as
the reference matches pytree keys.  Every emitted spec passes through
``validate_spec``, so every factory is safe on any mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..tree import named_leaves, unflatten
from .api import (NamedSharding, P, Rules, is_dtensor, logical_to_spec,
                  validate_spec)

# Mesh axes that carry the batch (data-parallel) dimension, major first.
DATA_AXES: Tuple[str, ...] = ("pod", "data")
MODEL_AXIS = "model"

# Logical axis -> mesh axes on the full ('pod', 'data', 'model') mesh.
#   batch    tokens/requests            -> all data-parallel axes
#   seq      sequence positions         -> replicated (Megatron-SP opt-in
#   act_seq  post-block residual seq       via 'act_seq' -> 'model')
#   kv_seq   cache positions            -> replicated (long-context opt-in)
#   embed    d_model features           -> replicated (FSDP opt-in -> data)
#   heads / ff / vocab / expert / inner -> tensor/expert parallel over 'model'
DEFAULT_RULES: Rules = {
    "batch": DATA_AXES,
    "seq": None,
    "act_seq": None,
    "kv_seq": None,
    "embed": None,
    "heads": MODEL_AXIS,
    "ff": MODEL_AXIS,
    "vocab": MODEL_AXIS,
    "expert": MODEL_AXIS,
    "inner": MODEL_AXIS,
}


def _on_mesh(value, axis_names) -> Any:
    """Restrict a rule value to axes present on the mesh (None if none
    are)."""
    if value is None:
        return None
    if isinstance(value, tuple):
        kept = tuple(ax for ax in value if ax in axis_names)
        return kept or None
    return value if value in axis_names else None


def make_rules(mesh, *, fsdp: bool = False, seq_activations: bool = False,
               long_context: bool = False) -> Rules:
    """Specialize DEFAULT_RULES to ``mesh`` plus the launch-time knobs.

    fsdp            ZeRO-3: params shard their d_model ('embed') dim over
                    the data axes.
    seq_activations Megatron-SP: the post-block residual stream ('act_seq')
                    shards over 'model'.
    long_context    decode caches shard their sequence dim ('kv_seq') over
                    'model'.
    """
    names = set(mesh.mesh_dim_names)
    rules: Rules = {k: _on_mesh(v, names) for k, v in DEFAULT_RULES.items()}
    if fsdp:
        rules["embed"] = _on_mesh(DATA_AXES, names)
    if seq_activations:
        rules["act_seq"] = _on_mesh(MODEL_AXIS, names)
    if long_context:
        rules["kv_seq"] = _on_mesh(MODEL_AXIS, names)
    return rules


def batch_spec(mesh, rules: Optional[Rules] = None):
    """Returns shard(x) -> NamedSharding: dim 0 over the batch axes.
    Dimensions the batch axes cannot divide replicate."""
    rules = rules if rules is not None else make_rules(mesh)
    batch_axes = rules.get("batch")

    def shard(spec_like) -> NamedSharding:
        shape = tuple(spec_like.shape)
        entries = [None] * len(shape)
        if shape:
            entries[0] = batch_axes
        return NamedSharding(mesh, validate_spec(P(*entries), shape, mesh))

    return shard


# Trailing-dim logical axes per parameter leaf name (leading stacked-layer /
# group dims pad with None).  MoE expert tensors carry a leading 'expert' dim.
_PARAM_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": ("vocab", "embed"),
    "unembed": ("embed", "vocab"),
    "router": (None, None),
    "wq": ("embed", "heads"),
    "wk": ("embed", "heads"),
    "wv": ("embed", "heads"),
    "wo": ("heads", "embed"),
    "w_gate": ("embed", "ff"),
    "w_up": ("embed", "ff"),
    "w_down": ("ff", "embed"),
    "in_proj": ("embed", "inner"),
    "out_proj": ("inner", "embed"),
    "x_proj": ("inner", None),
    "dt_proj": (None, "inner"),
    "bc_proj": ("embed", None),
    "conv_w": (None, "inner"),
    "conv_b": ("inner",),
    "dt_bias": ("inner",),
    "A_log": ("inner", None),
    "D": ("inner",),
}
_MOE_PARAM_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "w_gate": ("expert", "embed", "ff"),
    "w_up": ("expert", "embed", "ff"),
    "w_down": ("expert", "ff", "embed"),
}


def _right_aligned_spec(axes: Optional[Tuple[Optional[str], ...]],
                        shape, mesh, rules: Rules) -> P:
    """Logical axes bound to the *trailing* dims; leading dims replicate.
    Unknown names or rank mismatches replicate the whole leaf."""
    ndim = len(shape)
    if axes is None or ndim < len(axes):
        return P()
    entries = tuple(logical_to_spec(axes, rules))
    spec = P(*((None,) * (ndim - len(axes)) + entries))
    return validate_spec(spec, shape, mesh)


def _map_named(fn, tree):
    """``fn(names, leaf)`` over ``tree``'s leaves, ``names`` the parts of
    the leaf's path; the results in ``tree``'s structure."""
    return unflatten(tree, [fn(tuple(path.split("/")), leaf)
                            for path, leaf in named_leaves(tree)])


def param_shardings(cfg, params_spec: Any, mesh,
                    rules: Optional[Rules] = None) -> Any:
    """NamedSharding tree mirroring ``params_spec`` leaf for leaf.

    Leaves are matched by name against the logical-axis tables above;
    anything unrecognized (norm scales, biases) replicates."""
    del cfg  # matched by leaf name; cfg kept for API symmetry
    rules = rules if rules is not None else make_rules(mesh)

    def leaf(names, spec_like) -> NamedSharding:
        leaf_name = names[-1] if names else ""
        axes = _PARAM_AXES.get(leaf_name)
        if "moe" in names and leaf_name in _MOE_PARAM_AXES:
            axes = _MOE_PARAM_AXES[leaf_name]
        return NamedSharding(
            mesh, _right_aligned_spec(axes, tuple(spec_like.shape), mesh,
                                      rules))

    return _map_named(leaf, params_spec)


# Trailing-dim logical axes per cache leaf name.  KV caches are
# (B, S_max, n_kv, hd) under any number of stacked layer/group dims.
_CACHE_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "k": ("batch", "kv_seq", "heads", None),
    "v": ("batch", "kv_seq", "heads", None),
    "cross_k": ("batch", "kv_seq", "heads", None),
    "cross_v": ("batch", "kv_seq", "heads", None),
    "conv": ("batch", None, "inner"),
    "pos": (),
    "ready": (),
}


def cache_shardings(cfg, cache_spec: Any, mesh,
                    rules: Optional[Rules] = None) -> Any:
    """NamedSharding tree for a decode cache (KV, SSM state, or hybrid).
    The recurrent 'state' leaf is rank-dispatched per block family:
    Mamba-1 carries (B, d_inner, N), Mamba-2 (B, heads, headdim, N)."""
    rules = rules if rules is not None else make_rules(mesh)
    state_axes = (("batch", "inner", None) if cfg.block == "mamba1"
                  else ("batch", "inner", None, None))

    def leaf(names, spec_like) -> NamedSharding:
        leaf_name = names[-1] if names else ""
        axes = (_CACHE_AXES.get(leaf_name) if leaf_name != "state"
                else state_axes)
        return NamedSharding(
            mesh, _right_aligned_spec(axes, tuple(spec_like.shape), mesh,
                                      rules))

    return _map_named(leaf, cache_spec)


def distribute(x, sharding: NamedSharding):
    """``x`` as a ``DTensor`` on ``sharding``: a plain tensor (the same
    whole value on every rank) is cut into its shards, a ``DTensor`` is
    redistributed if its placements differ."""
    from torch.distributed.tensor import distribute_tensor

    placements = sharding.placements
    if is_dtensor(x):
        if tuple(x.placements) == tuple(placements):
            return x
        return x.redistribute(sharding.mesh, placements)
    # every rank holds the whole value: each keeps its own shard of it
    return distribute_tensor(x, sharding.mesh, placements,
                             src_data_rank=None)


def distribute_host(x, sharding: NamedSharding, device, dtype=None):
    """A whole tensor ``x`` on the host as a ``DTensor`` on ``sharding``:
    only this rank's shard of it is copied to ``device`` (in ``dtype``),
    so a leaf larger than one device's share never lands whole.  The
    shardings' specs are validated, so every split is even."""
    from torch.distributed.tensor import DTensor, Shard

    mesh, placements = sharding.mesh, sharding.placements
    coord = mesh.get_coordinate()
    local = x
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(i), dim=p.dim)[coord[i]]
    local = local.to(device=device, dtype=dtype, copy=True,
                     memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, run_check=False)


def distribute_tree(tree: Any, shardings: Any, keep: Tuple[str, ...] = ()
                    ) -> Any:
    """``distribute`` over a tree and its shardings leaf for leaf.  Leaves
    named in ``keep`` stay as they are (a KV cache's fill counters live on
    the host)."""
    named, shs = named_leaves(tree), named_leaves(shardings)
    if len(named) != len(shs):
        raise ValueError(f"{len(named)} leaves, {len(shs)} shardings")
    return unflatten(tree, [
        x if name.split("/")[-1] in keep else distribute(x, sh)
        for (name, x), (_, sh) in zip(named, shs)])


def gather_tree(tree: Any) -> Any:
    """Every ``DTensor`` leaf of ``tree`` as its whole value on this rank
    (a collective: every rank calls it); other leaves as they are."""
    return unflatten(tree, [x.full_tensor() if is_dtensor(x) else x
                            for _, x in named_leaves(tree)])
