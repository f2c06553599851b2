"""Nested containers of tensors ("trees"), flattened in the order JAX
flattens its pytrees: a dict by sorted key, a NamedTuple by field, a list
or tuple by index, ``None`` as no leaf.  The optimizers walk params, grads
and their states leaf by leaf in this order, and a checkpoint's
``leaf_<i>`` is the i-th leaf of it in both packages."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    raise TypeError(type(tree))


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs, the path's parts joined by ``/`` as the
    reference's checkpoint names them (``params/embed``, ``step``)."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix or "leaf", tree)]
    return [pair for name, child in _children(tree)
            for pair in named_leaves(child,
                                     f"{prefix}/{name}" if prefix else name)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in named_leaves(tree)]


def unflatten(skeleton, flat: List[Any]):
    """``skeleton``'s structure with its leaves replaced, in order, by
    ``flat``."""
    it = iter(flat)

    def build(node):
        if node is None:
            return None
        if not _is_node(node):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        rebuilt = [build(x) for x in node]
        if hasattr(node, "_fields"):
            return type(node)(*rebuilt)
        return type(node)(rebuilt)

    out = build(skeleton)
    if next(it, None) is not None:
        raise ValueError("more leaves than the skeleton holds")
    return out


def map_leaves(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    flats = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flats[0]) for f in flats):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*flats)])
