"""Faults planted under the timed path, for the control runs and the
tests that must see ``correct`` come out false.

Each is a hook of ``bench.run_cell``: ``train_step`` takes the
program's step factory and returns one, ``run_wave`` takes the engine
and serves a wave.
"""
from __future__ import annotations

import numpy as np


def state_unchanged(make_step):
    """A step that computes the loss and returns its state as it was."""
    def factory(cfg, opt):
        import torch
        from repro_torch.models import loss_fn

        def step(state, batch):
            with torch.no_grad():
                _, metrics = loss_fn(cfg, state.params, batch)
            return state, {"loss": metrics["loss"]}
        return step
    return factory


def half_batch(make_step):
    """A step on the first half of the batch's rows only: the mean is
    taken over the rest."""
    def factory(cfg, opt):
        real = make_step(cfg, opt)

        def step(state, batch):
            return real(state, {k: v[:v.shape[0] // 2]
                                for k, v in batch.items()})
        return step
    return factory


def token_altered(vocab: int):
    """Each wave's results with one served token of every request moved
    to the next id."""
    def run_wave(engine):
        results = engine.run_wave()
        for r in results:
            if len(r.tokens):
                k = len(r.tokens) // 2
                r.tokens = np.array(r.tokens)
                r.tokens[k] = (int(r.tokens[k]) + 1) % vocab
        return results
    return run_wave


def wave_halved(vocab: int):
    """Each wave's results for the first half of its requests only: the
    rest are taken from the queue and never come back."""
    def run_wave(engine):
        results = engine.run_wave()
        return results[:max(1, len(results) // 2)]
    return run_wave


def cache_unchanged(vocab: int):
    """Each wave served by decode steps that return the KV cache as they
    got it: every step writes its token over the first served one, at the
    same position, so later tokens attend to the prompt and the one token
    before them only."""
    def run_wave(engine):
        from repro_torch.serve import engine as served
        real = served.decode_step

        def step(cfg, params, tokens, cache):
            return real(cfg, params, tokens, cache)[0], cache

        served.decode_step = step
        try:
            return engine.run_wave()
        finally:
            served.decode_step = real
    return run_wave


TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch}
SERVE = {"token_altered": token_altered, "wave_halved": wave_halved,
         "cache_unchanged": cache_unchanged}
