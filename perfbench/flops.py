"""The benchmark's own arithmetic: model FLOPs, optimizer bytes, peaks.

Counted from a configuration file's sizes, never from the program.
Model FLOPs count each multiply-add of the model's matrix products as
two operations: the projections and MLPs (for a mixture of experts the
router and the ``top_k`` experts a token uses, not the capacity's
padding), the output head over the published vocabulary, and causal
attention (QK^T and PV over the keys at or before each query).  The
embedding lookup, recomputation and padding count nothing.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, Iterable, Optional

PEAKS = pathlib.Path(__file__).with_name("peaks.json")


def matmul_params(conf: Dict) -> int:
    """Weights a token multiplies through, embedding lookup excluded."""
    d, hd = conf["hidden_size"], conf["head_dim"]
    nh, nkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    f, e = conf["intermediate_size"], conf.get("num_experts", 0)
    attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
    mlp = 3 * d * f
    ffn = d * e + conf["num_experts_per_tok"] * mlp if e else mlp
    return conf["num_hidden_layers"] * (attn + ffn) \
        + d * conf["vocab_size"]


def attention_flops(conf: Dict, queries: int, first_key: int = 0) -> int:
    """Forward FLOPs of causal attention for ``queries`` consecutive
    queries of one sequence, the first at position ``first_key``: query
    ``i`` attends to ``first_key + i + 1`` keys, each key 2·hd for QK^T
    and 2·hd for PV, in every head of every layer."""
    keys = queries * first_key + queries * (queries + 1) // 2
    return 4 * conf["num_hidden_layers"] * conf["num_attention_heads"] \
        * conf["head_dim"] * keys


def train_step_flops(conf: Dict, batch: int, seq: int) -> int:
    """Forward and backward (3x the forward) of one step."""
    fwd = 2 * matmul_params(conf) * batch * seq \
        + batch * attention_flops(conf, seq)
    return 3 * fwd


def serve_request_flops(conf: Dict, prompt: int, generated: int) -> int:
    """The forward passes one request needs: a prefill over its own
    prompt, then one pass for each generated token after the first, each
    attending over the request's own context."""
    n = 2 * matmul_params(conf)
    flops = n * prompt + attention_flops(conf, prompt)
    for j in range(1, generated):
        flops += n + attention_flops(conf, 1, prompt + j - 1)
    return flops


def adamw_bytes(leaf_sizes: Iterable[tuple]) -> int:
    """The least bytes of one AdamW update: each parameter read and
    written once, its gradient (of the parameter's type) read once, and
    the float32 first and second moments read and written once.
    ``leaf_sizes``: (numel, bytes an element) of each parameter."""
    return sum(n * (3 * b + 16) for n, b in leaf_sizes)


def peak(kind: str, name: str) -> Optional[float]:
    """The data sheet's peak ``name`` of the card ``kind``, or None for a
    card the table does not hold."""
    table = json.loads(PEAKS.read_text())["cards"]
    for card in table:
        if kind.startswith(card["kind"]):
            return card[name]
    return None
