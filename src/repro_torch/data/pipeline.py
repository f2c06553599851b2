"""Deterministic, host-sharded data pipeline: a copy of
``repro/data/pipeline.py`` (pure numpy), so the port's batches are the
reference's byte for byte.  The launcher moves them to the device.

Synthetic-but-structured token streams (Zipf-distributed n-gram chains, so
loss actually decreases during training).  Determinism is keyed by
(seed, step, host), which makes checkpoint-restart exact: a restarted job
regenerates precisely the batches it would have seen — the data-side half of
fault tolerance (``runtime/ft.py`` is the compute-side half).  Double-buffered
prefetch thread included.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.3
    frontend: str = "none"          # mirrors ModelConfig.frontend
    n_frontend_tokens: int = 0
    d_frontend: int = 0


class SyntheticLMDataset:
    """Markov-chain token generator: next ~ Zipf(state) with a deterministic
    per-(step,host) PRNG; labels are tokens shifted left."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_hosts == 0, \
            "global batch must divide over hosts"
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts
        # a small fixed transition table makes the stream learnable
        rng = np.random.default_rng(cfg.seed)
        self._shift = rng.integers(1, cfg.vocab, size=64)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4093 + cfg.host_id)
        b, s = self.local_batch, cfg.seq_len
        noise = rng.zipf(cfg.zipf_a, size=(b, s)).astype(np.int64)
        noise = np.minimum(noise, cfg.vocab - 1)
        toks = np.empty((b, s), np.int64)
        toks[:, 0] = noise[:, 0]
        for t in range(1, s):
            # learnable structure: x_t = x_{t-1} + shift[x_{t-1} % 64] + eps
            det = (toks[:, t - 1]
                   + self._shift[toks[:, t - 1] % 64]) % cfg.vocab
            use_noise = rng.random(b) < 0.15
            toks[:, t] = np.where(use_noise, noise[:, t], det)
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if cfg.frontend == "vision_stub":
            batch["vision_embeds"] = rng.standard_normal(
                (b, cfg.n_frontend_tokens, cfg.d_frontend)
            ).astype(np.float32) * 0.02
        if cfg.frontend == "audio_stub":
            batch["audio_frames"] = rng.standard_normal(
                (b, cfg.n_frontend_tokens, cfg.d_frontend)
            ).astype(np.float32) * 0.02
        return batch

    def iterate(self, start_step: int = 0,
                prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
        """Prefetching iterator starting at `start_step` (restart-exact)."""
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                q.put(self.batch_at(step))
                step += 1

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def make_dataset(model_cfg, seq_len: int, global_batch: int, seed: int = 0,
                 n_hosts: int = 1, host_id: int = 0) -> SyntheticLMDataset:
    return SyntheticLMDataset(DataConfig(
        vocab=model_cfg.vocab, seq_len=seq_len + 1,
        global_batch=global_batch, seed=seed, n_hosts=n_hosts,
        host_id=host_id,
        frontend=(model_cfg.frontend if model_cfg.frontend != "none"
                  else ("audio_stub" if model_cfg.block == "encdec"
                        else "none")),
        n_frontend_tokens=(model_cfg.n_vision_tokens
                           if model_cfg.frontend == "vision_stub"
                           else model_cfg.n_audio_frames),
        d_frontend=model_cfg.d_model,
    ))
