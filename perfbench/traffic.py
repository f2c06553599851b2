"""The benchmark's traffic generator: every mix file is read here.

Tokens come from a Zipf Markov chain (a copy of the program's
``SyntheticLMDataset`` idea, vectorised over rows): each token is the
previous one plus a shift from a small table, or, with probability
``noise``, a fresh Zipf draw, so routing and the loss see skewed ids.

Sizes never depend on the seed: the seed draws the tokens and the order
of a fixed set of sizes, so every seed does the same work.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(seed,
                                                        spawn_key=(stream,)))


def markov_tokens(gen: np.random.Generator, rows: int, length: int,
                  vocab: int, zipf_a: float, noise: float) -> np.ndarray:
    """(rows, length) int64 token ids below ``vocab``."""
    shift = gen.integers(1, vocab, size=64)
    fresh = np.minimum(gen.zipf(zipf_a, size=(rows, length)), vocab - 1)
    use_fresh = gen.random((rows, length)) < noise
    toks = np.empty((rows, length), np.int64)
    toks[:, 0] = fresh[:, 0]
    for t in range(1, length):
        prev = toks[:, t - 1]
        toks[:, t] = np.where(use_fresh[:, t], fresh[:, t],
                              (prev + shift[prev % 64]) % vocab)
    return toks


def train_batches(mix: Dict, vocab: int, seed: int) -> np.ndarray:
    """``mix["pool_batches"]`` batches of ``batch`` rows of ``seq_len + 1``
    tokens: (pool, batch, seq_len + 1); inputs and labels are the two
    shifted views of a row."""
    b, s, n = mix["batch"], mix["seq_len"], mix["pool_batches"]
    toks = markov_tokens(rng(seed, 0), n * b, s + 1, vocab, mix["zipf_a"],
                         mix["noise"])
    return toks.reshape(n, b, s + 1)


def wave_lengths(mix: Dict) -> List[int]:
    """The prompt lengths of every wave: the middle of each of
    ``wave_size`` equal strata of the log-uniform law over [lo, hi].
    Every wave, and every seed, does the same work, so a window's rate
    does not depend on how many waves it holds."""
    lo, hi, n = mix["prompt_min"], mix["prompt_max"], mix["wave_size"]
    return [int(round(lo * (hi / lo) ** ((i + 0.5) / n))) for i in range(n)]


def serve_requests(mix: Dict, vocab: int, seed: int) -> List[Dict]:
    """``mix["pool_waves"]`` waves of requests, wave after wave, each
    wave's lengths in an order drawn from the seed.  Each request:
    ``{"wave", "prompt" (int64 array), "max_new_tokens"}``."""
    gen = rng(seed, 1)
    n_waves, size = mix["pool_waves"], mix["wave_size"]
    toks = markov_tokens(gen, n_waves * size, mix["prompt_max"], vocab,
                         mix["zipf_a"], mix["noise"])
    # a prompt never starts with the engine's padding id
    toks[:, 0] = np.maximum(toks[:, 0], 1)
    out = []
    for w in range(n_waves):
        lengths = gen.permutation(wave_lengths(mix))
        for i, n in enumerate(lengths):
            out.append({"wave": w, "prompt": toks[w * size + i, :int(n)],
                        "max_new_tokens": mix["new_tokens"]})
    return out
