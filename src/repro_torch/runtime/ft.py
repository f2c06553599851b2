"""Fault tolerance, the counterpart of ``repro/runtime/ft.py``: heartbeat
monitoring, straggler detection, scripted fault injection and the
checkpoint/restart training loop.

``DSEService`` tracks its dispatcher's liveness with a
:class:`HeartbeatMonitor` and takes a :class:`FaultInjector` to script
failed dispatches in tests.  :class:`FaultTolerantLoop` drives a train step
(``launch/steps.py``) over the deterministic data pipeline, checkpoints it
with a ``checkpoint.CheckpointManager`` and, after a fault, restores the
latest checkpoint onto its device and goes on from there.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np


class HeartbeatMonitor:
    """Tracks liveness of workers; `dead()` lists workers whose last
    heartbeat is older than timeout_s."""

    def __init__(self, n_workers: int, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        self.last: Dict[int, float] = {w: clock() for w in range(n_workers)}

    def beat(self, worker: int, at: Optional[float] = None):
        self.last[worker] = self.clock() if at is None else at

    def dead(self) -> List[int]:
        now = self.clock()
        return [w for w, t in self.last.items()
                if now - t > self.timeout_s]

    def healthy(self) -> bool:
        return not self.dead()


class StragglerDetector:
    """Flags workers whose step time exceeds `factor` x the fleet median
    over a sliding window — the trigger for straggler mitigation (drop the
    host from the data-parallel group / re-replicate its shard)."""

    def __init__(self, n_workers: int, window: int = 16,
                 factor: float = 2.0):
        self.window = window
        self.factor = factor
        self.times: Dict[int, List[float]] = {w: [] for w in range(n_workers)}

    def record(self, worker: int, step_time_s: float):
        buf = self.times[worker]
        buf.append(step_time_s)
        if len(buf) > self.window:
            buf.pop(0)

    def stragglers(self) -> List[int]:
        med_all = [np.median(b) for b in self.times.values() if b]
        if not med_all:
            return []
        fleet_median = float(np.median(med_all))
        out = []
        for w, b in self.times.items():
            if b and float(np.median(b)) > self.factor * fleet_median:
                out.append(w)
        return out


class FaultInjector:
    """Deterministic fault injection for tests: raises at given steps, once
    each."""

    def __init__(self, fail_at_steps=()):
        self.remaining = set(fail_at_steps)

    def check(self, step: int):
        if step in self.remaining:
            self.remaining.discard(step)
            raise RuntimeError(f"injected fault at step {step}")


@dataclasses.dataclass
class LoopResult:
    final_step: int
    restarts: int
    metrics_history: List[Dict[str, float]]


class FaultTolerantLoop:
    """Checkpoint/restart loop around an arbitrary train step.

    train_step: (state, batch) -> (state, metrics)
    make_state: () -> fresh state   (used on cold start)
    batch_at:   step -> batch       (deterministic data pipeline)

    A checkpoint restores onto ``device`` in ``abstract_state``'s structure
    (shapes and dtypes, e.g. ``meta`` tensors), and with ``shardings`` onto
    a mesh (the state's ``NamedSharding`` tree), whatever mesh wrote it.
    """

    def __init__(self, train_step, make_state, batch_at, ckpt_manager,
                 ckpt_every: int = 50, device=None, shardings=None,
                 abstract_state=None,
                 fault_injector: Optional[FaultInjector] = None,
                 max_restarts: int = 10):
        self.train_step = train_step
        self.make_state = make_state
        self.batch_at = batch_at
        self.ckpt = ckpt_manager
        self.ckpt_every = ckpt_every
        self.device = device
        self.shardings = shardings
        self.abstract_state = abstract_state
        self.injector = fault_injector
        self.max_restarts = max_restarts

    def _start_state(self):
        if self.abstract_state is not None:
            restored, step = self.ckpt.restore(self.abstract_state,
                                               self.device,
                                               shardings=self.shardings)
            if restored is not None:
                return restored, int(step)
        return self.make_state(), 0

    def run(self, total_steps: int, on_metrics=None) -> LoopResult:
        restarts = -1
        history: List[Dict[str, float]] = []
        while restarts < self.max_restarts:
            restarts += 1
            state, step = self._start_state()
            # A restart resumes from the restored checkpoint step, so any
            # metrics recorded past it belong to work that is about to be
            # re-run: drop them, or the history carries duplicate steps.
            history[:] = [m for m in history if m["step"] <= step]
            try:
                while step < total_steps:
                    if self.injector is not None:
                        self.injector.check(step)
                    batch = self.batch_at(step)
                    state, metrics = self.train_step(state, batch)
                    step += 1
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step
                    history.append(m)
                    if on_metrics:
                        on_metrics(m)
                    if step % self.ckpt_every == 0:
                        self.ckpt.save(step, state)
                # final checkpoint + done
                self.ckpt.save(step, state)
                self.ckpt.wait()
                return LoopResult(final_step=step, restarts=restarts,
                                  metrics_history=history)
            except RuntimeError as e:
                # a worker died: on a real cluster the job restarts; here we
                # loop back, restore the latest checkpoint and continue.
                # The failed run's state goes before the restore allocates.
                state = batch = None
                print(f"[ft] fault at step {step}: {e} — restarting "
                      f"({restarts + 1}/{self.max_restarts})")
                continue
        raise RuntimeError("exceeded max restarts")
