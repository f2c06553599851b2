"""Weights drawn from the seed, by the benchmark, for both sides.

The leaves have the paths, shapes, types and scales of the program's
parameter tree (a stacked leaf carries a leading layer axis; the vocab
rows are stored padded), so the same tensors go to the program and,
as float32, to the reference.  Each leaf is one draw on the device from
a generator of its own, seeded from (seed, leaf index): a leaf can be
drawn again alone, bit for bit, for the reference or for a change.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Tuple, Union

import numpy as np
import torch

from perfbench import bench

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Leaf(NamedTuple):
    path: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    # "normal" (times ``scale``), "ones", "zeros", or a family's own
    # start: fill(generator, shape, dtype, device) -> tensor
    fill: Union[str, Callable]
    scale: float = 1.0


def leaves(conf: Dict, qk_gain: float = 1.0) -> List[Leaf]:
    """The parameter leaves of a configuration, as its model family
    (``perfbench/families/<family>.py``) gives them, in sorted path
    order.  ``qk_gain`` multiplies the scale of the query and key
    projections, where the family has them."""
    table = bench.family(conf).leaves(conf, qk_gain)
    return sorted(table, key=lambda leaf: leaf.path.split("/"))


def vocab_stored(conf: Dict) -> int:
    """Rows of the embedding and the head as the program stores them:
    the vocabulary padded to ``vocab_pad_multiple``."""
    pad = conf.get("vocab_pad_multiple", 1)
    return -(-conf["vocab_size"] // pad) * pad


def leaf_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for leaf ``index`` of run ``seed``."""
    words = np.random.SeedSequence(seed, spawn_key=(index,)).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def draw(leaf: Leaf, index: int, seed: int, device, dtype=None
         ) -> torch.Tensor:
    """Leaf ``index``'s initial value, in ``dtype`` (default: its own)."""
    if leaf.fill == "normal" or callable(leaf.fill):
        g = torch.Generator(device=device)
        g.manual_seed(leaf_seed(seed, index))
        if callable(leaf.fill):
            t = leaf.fill(g, leaf.shape, leaf.dtype, device)
        else:
            t = torch.randn(leaf.shape, generator=g, device=device,
                            dtype=leaf.dtype)
            t.mul_(leaf.scale)
    else:
        t = (torch.ones if leaf.fill == "ones" else torch.zeros)(
            leaf.shape, device=device, dtype=leaf.dtype)
    return t if dtype is None else t.to(dtype)


def draw_all(conf: Dict, seed: int, device, dtype=None, qk_gain: float = 1.0
             ) -> Dict[str, torch.Tensor]:
    """Every leaf as ``{path: tensor}``."""
    return {leaf.path: draw(leaf, i, seed, device, dtype)
            for i, leaf in enumerate(leaves(conf, qk_gain))}


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """``{"a/b": t}`` -> ``{"a": {"b": t}}``: the program's tree."""
    tree: Dict = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = t
    return tree


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The inverse of ``nest``, in sorted path order."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{prefix}/{k}" if prefix else k))
    return out
