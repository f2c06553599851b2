"""The traffic generator: what the seed draws and what it leaves fixed."""
import json

import numpy as np

from perfbench import traffic
from perfbench.tests.conftest import REPO

MIXES = REPO / "perfbench" / "traffic"


def mix_of(name, **sizes):
    mix = json.loads((MIXES / f"{name}.json").read_text())
    mix.update(sizes)
    return mix


def test_seed_draws_the_training_batches():
    mix = mix_of("train-4x4096", seq_len=48, pool_batches=4)
    pool = traffic.train_batches(mix, 512, 2**40 + 3)
    assert pool.shape == (4, mix["batch"], 49)
    assert np.array_equal(pool, traffic.train_batches(mix, 512, 2**40 + 3))
    assert not np.array_equal(pool, traffic.train_batches(mix, 512,
                                                          2**40 + 4))
    rows = pool.reshape(-1, 49)
    assert len({r.tobytes() for r in rows}) == len(rows)


def test_every_serving_wave_has_the_same_lengths():
    mix = mix_of("serve-longprompt", pool_waves=3, prompt_min=16,
                 prompt_max=600)
    for seed in (1, 2**35 + 1):
        reqs = traffic.serve_requests(mix, 512, seed)
        for w in range(3):
            lengths = sorted(len(r["prompt"]) for r in reqs
                             if r["wave"] == w)
            assert lengths == sorted(traffic.wave_lengths(mix))
