"""Wave formation for the DSE service (the counterpart of
``repro/serve/engine.py``'s ``form_wave``; its token-serving engine belongs
to the model stack)."""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple, TypeVar

_T = TypeVar("_T")


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
