"""Fault tolerance for the DSE service: heartbeat monitoring, straggler
detection and scripted fault injection (the counterpart of the first half
of ``repro/runtime/ft.py``; its checkpoint/restart training loop belongs to
the model stack).

``DSEService`` tracks its dispatcher's liveness with a
:class:`HeartbeatMonitor` and takes a :class:`FaultInjector` to script
failed dispatches in tests.
"""
from __future__ import annotations

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
