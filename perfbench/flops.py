"""The benchmark's own arithmetic: model FLOPs, optimizer bytes, peaks.

Counted from a configuration file's sizes, never from the program.  A
step's or a request's model FLOPs are its model family's count
(``perfbench/families/<family>.py``); this module keeps what every
family shares: causal attention's FLOPs, AdamW's bytes and the card's
peaks.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, Iterable, Optional

from perfbench import bench

PEAKS = pathlib.Path(__file__).with_name("peaks.json")


def attention_flops(conf: Dict, queries: int, first_key: int = 0) -> int:
    """Forward FLOPs of causal attention for ``queries`` consecutive
    queries of one sequence, the first at position ``first_key``: query
    ``i`` attends to ``first_key + i + 1`` keys, each key 2·hd for QK^T
    and 2·hd for PV, in every head of every layer."""
    keys = queries * first_key + queries * (queries + 1) // 2
    return 4 * conf["num_hidden_layers"] * conf["num_attention_heads"] \
        * conf["head_dim"] * keys


def train_step_flops(conf: Dict, batch: int, seq: int) -> int:
    """Model FLOPs of one training step (forward and backward) over
    ``batch`` rows of ``seq`` tokens."""
    return bench.family(conf).train_step_flops(conf, batch, seq)


def serve_request_flops(conf: Dict, prompt: int, generated: int) -> int:
    """Model FLOPs of serving one request: its prompt's prefill and a
    pass for each generated token after the first."""
    return bench.family(conf).serve_request_flops(conf, prompt, generated)


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
