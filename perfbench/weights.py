"""Weights drawn from the seed, by the benchmark, for both sides.

The leaves have the paths, shapes, types and scales of the program's
parameter tree (a stacked leaf carries a leading layer axis; the vocab
rows are stored padded), so the same tensors go to the program and,
as float32, to the reference.  Each leaf is one draw on the device from
a generator of its own, seeded from (seed, leaf index): a leaf can be
drawn again alone, bit for bit, for the reference or for a change.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Leaf(NamedTuple):
    path: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    fill: str           # "normal", "ones" or "zeros"
    scale: float = 1.0


def leaves(conf: Dict, qk_gain: float = 1.0) -> List[Leaf]:
    """The parameter leaves of a configuration, in sorted path order.
    ``qk_gain`` multiplies the scale of the query and key projections,
    and so the spread of the attention logits by its square."""
    dt = DTYPES[conf["torch_dtype"]]
    L, d = conf["num_hidden_layers"], conf["hidden_size"]
    nh, nkv, hd = (conf["num_attention_heads"], conf["num_key_value_heads"],
                   conf["head_dim"])
    f = conf["intermediate_size"]
    pad = conf.get("vocab_pad_multiple", 1)
    vp = -(-conf["vocab_size"] // pad) * pad
    out = [Leaf("embed", (vp, d), dt, "normal", d ** -0.5)]

    def norm(path, lead):
        if conf["norm"] == "layernorm":
            out.extend([Leaf(path + "/bias", lead + (d,), dt, "zeros"),
                        Leaf(path + "/scale", lead + (d,), dt, "ones")])
        else:
            out.append(Leaf(path, lead + (d,), dt, "ones"))

    norm("ln_f", ())
    lay = "stack/layers/"
    out += [Leaf(lay + "attn/wq", (L, d, nh * hd), dt, "normal",
                 qk_gain * d ** -0.5),
            Leaf(lay + "attn/wk", (L, d, nkv * hd), dt, "normal",
                 qk_gain * d ** -0.5),
            Leaf(lay + "attn/wv", (L, d, nkv * hd), dt, "normal", d ** -0.5),
            Leaf(lay + "attn/wo", (L, nh * hd, d), dt, "normal",
                 (nh * hd) ** -0.5)]
    norm(lay + "ln1", (L,))
    norm(lay + "ln2", (L,))
    e = conf.get("num_experts", 0)
    if e:
        out += [Leaf(lay + "moe/router", (L, d, e), torch.float32, "normal",
                     d ** -0.5),
                Leaf(lay + "moe/w_gate", (L, e, d, f), dt, "normal",
                     d ** -0.5),
                Leaf(lay + "moe/w_up", (L, e, d, f), dt, "normal", d ** -0.5),
                Leaf(lay + "moe/w_down", (L, e, f, d), dt, "normal",
                     f ** -0.5)]
    else:
        out += [Leaf(lay + "mlp/w_gate", (L, d, f), dt, "normal", d ** -0.5),
                Leaf(lay + "mlp/w_up", (L, d, f), dt, "normal", d ** -0.5),
                Leaf(lay + "mlp/w_down", (L, f, d), dt, "normal", f ** -0.5)]
    if not conf["tie_word_embeddings"]:
        out.append(Leaf("unembed", (d, vp), dt, "normal", d ** -0.5))
    return sorted(out, key=lambda leaf: leaf.path.split("/"))


def leaf_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for leaf ``index`` of run ``seed``."""
    words = np.random.SeedSequence(seed, spawn_key=(index,)).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def draw(leaf: Leaf, index: int, seed: int, device, dtype=None
         ) -> torch.Tensor:
    """Leaf ``index``'s initial value, in ``dtype`` (default: its own)."""
    if leaf.fill == "normal":
        g = torch.Generator(device=device)
        g.manual_seed(leaf_seed(seed, index))
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
