"""Batched serving engine: wave-scheduled prefill + decode, the counterpart
of ``repro/serve/engine.py``.

Requests queue up; the engine forms waves of up to `max_batch` requests,
left-pads prompts to a common length (token 0, no padding mask, as the
reference does), prefills once, then decodes all slots in lockstep with
per-slot early-stop masks (finished slots keep decoding into a sink but
their outputs are frozen).  Greedy or temperature sampling: greedy is the
argmax, as in the reference; temperature sampling draws from a
``torch.Generator`` seeded from ``seed`` (the reference's
``jax.random.categorical`` stream cannot be replayed).  ``form_wave`` is
shared with the DSE service.

Traced (``runtime.trace``), a wave is the span ``serve.wave`` over
``serve.admit``, ``serve.prefill`` and each step's ``serve.sample`` and
``serve.decode``; the counters ``serve.prefill_positions`` and
``serve.prompt_tokens`` take its padded and real prompt positions; and
each request leaves a ``serve.request`` record of its submit, admit,
first-token and finish times (``perf_counter_ns``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple, TypeVar

import numpy as np
import torch

from ..models import ModelConfig, decode_step, init_cache, prefill
from ..runtime import trace

_T = TypeVar("_T")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (len,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    temperature: float = 0.0


@dataclasses.dataclass
class Result:
    uid: int
    tokens: np.ndarray          # generated tokens (without prompt)
    prompt_len: int
    steps: int
    error: Optional[str] = None  # set iff the request was rejected


def form_wave(queue: List[_T], max_count: int,
              fits_alone: Callable[[_T], bool],
              fits_with: Callable[[Sequence[_T], _T], bool]
              ) -> Tuple[List[_T], List[_T]]:
    """Admission-controlled FIFO wave formation.

    Pops from the FRONT of ``queue`` (in place) into a wave of at most
    ``max_count`` items: an item that can never run (``fits_alone`` false)
    is popped into ``rejected`` — it must not crash or starve the wave — and
    an item that fits alone but not with the current wave ends the wave
    (FIFO order is preserved: it will head the next wave).  Guarantees
    progress: a non-empty queue always yields at least one wave or rejected
    item, so a draining loop terminates."""
    wave: List[_T] = []
    rejected: List[_T] = []
    while queue and len(wave) < max_count:
        nxt = queue[0]
        if not fits_alone(nxt):
            rejected.append(queue.pop(0))
            continue
        if wave and not fits_with(wave, nxt):
            break
        wave.append(queue.pop(0))
    return wave, rejected


class ServeEngine:
    """Serves ``params`` on the device they live on."""

    def __init__(self, cfg: ModelConfig, params, max_batch: int = 8,
                 max_len: int = 512, seed: int = 0):
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.queue: List[Request] = []
        self.device = params["embed"].device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.waves = 0
        # submit times of the queued requests submitted while traced
        self._submitted = {}

    def submit(self, req: Request):
        if trace.enabled():
            self._submitted[id(req)] = time.perf_counter_ns()
        self.queue.append(req)

    def _fits_alone(self, r: Request) -> bool:
        return len(r.prompt) + r.max_new_tokens <= self.max_len

    def _fits_with(self, wave: Sequence[Request], r: Request) -> bool:
        # waves left-pad to the longest prompt and decode to the longest
        # max_new, so the wave's footprint is max(plen) + max(max_new)
        plen = max(len(x.prompt) for x in wave) if wave else 0
        max_new = max(x.max_new_tokens for x in wave) if wave else 0
        return (max(plen, len(r.prompt))
                + max(max_new, r.max_new_tokens)) <= self.max_len

    def _wave(self) -> Tuple[List[Request], List[Result]]:
        """Length-aware wave formation: only requests whose combined
        ``plen + max_new`` fits ``max_len`` pack together, and a single
        unfittable request yields a per-request error Result."""
        wave, rejected = form_wave(self.queue, self.max_batch,
                                   self._fits_alone, self._fits_with)
        for r in rejected:
            self._submitted.pop(id(r), None)
        errors = [Result(uid=r.uid, tokens=np.zeros(0, np.int32),
                         prompt_len=len(r.prompt), steps=0,
                         error=(f"request {r.uid}: prompt_len "
                                f"{len(r.prompt)} + max_new_tokens "
                                f"{r.max_new_tokens} exceeds engine "
                                f"max_len {self.max_len}"))
                  for r in rejected]
        return wave, errors

    def _batch(self, wave: List[Request], plen: int):
        """The wave's prompts left-padded to ``plen`` (with token 0) and
        its stub inputs, on the device."""
        B = len(wave)
        toks = np.zeros((B, plen), np.int64)
        for i, r in enumerate(wave):
            toks[i, plen - len(r.prompt):] = r.prompt

        dev, dt = self.device, self.cfg.torch_dtype
        batch = {"tokens": torch.as_tensor(toks, device=dev)}
        if self.cfg.frontend == "vision_stub":
            batch["vision_embeds"] = torch.zeros(
                (B, self.cfg.n_vision_tokens, self.cfg.d_model), dtype=dt,
                device=dev)
        if self.cfg.block == "encdec":
            batch["audio_frames"] = torch.zeros(
                (B, self.cfg.n_audio_frames, self.cfg.d_model), dtype=dt,
                device=dev)
        return batch

    @torch.inference_mode()
    def run_wave(self) -> List[Result]:
        number = self.waves
        self.waves += 1
        with trace.span("serve.wave", device=True, attrs={"wave": number}):
            return self._run_wave(number)

    def _run_wave(self, number: int) -> List[Result]:
        with trace.span("serve.admit"):
            wave, errors = self._wave()
            submitted = [self._submitted.pop(id(r), None) for r in wave]
            if not wave:
                return errors
            B = len(wave)
            plen = max(len(r.prompt) for r in wave)
            max_new = max(r.max_new_tokens for r in wave)
            total = plen + max_new
            # invariant by construction of _wave (fits_alone/fits_with)
            assert total <= self.max_len, "wave packer violated max_len"
            batch = self._batch(wave, plen)
        admitted = time.perf_counter_ns()
        trace.annotate(B=B, plen=plen, max_new=max_new)
        trace.count("serve.prefill_positions", B * plen)
        trace.count("serve.prompt_tokens", sum(len(r.prompt) for r in wave))

        with trace.span("serve.prefill", device=True):
            cache = init_cache(self.cfg, B, total, self.device)
            logits, cache = prefill(self.cfg, self.params, batch, cache)

        out = np.zeros((B, max_new), np.int32)
        done = np.zeros(B, bool)
        steps = 0
        first = None
        for t in range(max_new):
            with trace.span("serve.sample"):
                nxt = self._sample(logits, wave)
                nxt_np = nxt.cpu().numpy()
            first = first or time.perf_counter_ns()
            for i, r in enumerate(wave):
                if not done[i]:
                    out[i, t] = nxt_np[i]
                    if r.eos_id is not None and nxt_np[i] == r.eos_id:
                        done[i] = True
                    if t + 1 >= r.max_new_tokens:
                        done[i] = True
            steps += 1
            if done.all():
                break
            with trace.span("serve.decode"):
                logits, cache = decode_step(self.cfg, self.params,
                                            nxt[:, None], cache)

        results = []
        for i, r in enumerate(wave):
            n = min(r.max_new_tokens, max_new)
            toks_i = out[i, :n]
            if r.eos_id is not None and (toks_i == r.eos_id).any():
                toks_i = toks_i[:int(np.argmax(toks_i == r.eos_id)) + 1]
            results.append(Result(uid=r.uid, tokens=toks_i,
                                  prompt_len=len(r.prompt), steps=steps))
        if trace.enabled():
            finished = time.perf_counter_ns()
            for r, sub in zip(wave, submitted):
                trace.record("serve.request", uid=r.uid, wave=number,
                             submit_ns=sub, admit_ns=admitted,
                             first_token_ns=first, finish_ns=finished)
        return errors + results

    def _sample(self, logits: torch.Tensor, wave: List[Request]
                ) -> torch.Tensor:
        temps = torch.tensor([r.temperature for r in wave],
                             dtype=torch.float32)
        greedy = torch.argmax(logits, dim=-1)
        if (temps == 0).all():
            return greedy
        temps = temps.to(logits.device)
        scaled = logits / torch.clamp(temps[:, None], min=1e-4)
        # Gumbel-max: argmax(scaled + Gumbel noise) is a categorical draw
        u = torch.rand(scaled.shape, generator=self.generator,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
        sampled = torch.argmax(scaled + gumbel, dim=-1)
        return torch.where(temps == 0, greedy, sampled)

    def run_all(self) -> List[Result]:
        results = []
        while self.queue:
            results.extend(self.run_wave())
        return results
