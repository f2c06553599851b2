"""The port's in-memory tracer: spans and counters at the layer boundaries
of training and serving.

Tracing is off until ``enable()``.  Off, ``span`` is one test of a module
flag that returns a shared null context, and ``count``, ``record`` and
``annotate`` return after the same test: no ``record_function``, no CUDA
event, no allocation, no wait for the card.

On, a span keeps in memory its name, id, parent id, thread, attributes
and ``perf_counter_ns`` start and end; and while a profiler runs, it
enters ``torch.profiler.record_function("repro_torch." + name)``, so that
the profile holds it as a ``user_annotation`` on the profiler's own
clock, the clock of the kernels (without a profiler that call would cost
more than the rest of the span and record nothing).  The parent is the innermost span open on the same thread
(a ``threading.local`` stack): under remat, autograd's thread replays the
forward, and the replay's spans are that thread's.  A span opened with
``device=True`` also records a CUDA event at each end, for its time on the
card outside a profile; only coarse spans (a train step, a serving wave,
a prefill) take them.  A counter keeps Python ints summed and device
tensors unread until ``drain()``, which waits for the card once, then
returns and clears what was recorded.

Names, nesting and what reads them: PERF.md, section 3.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch

PREFIX = "repro_torch."

_ON = False
_LOCK = threading.Lock()
_LOCAL = threading.local()
_NULL = contextlib.nullcontext()
_IDS = itertools.count(1)
_SPANS: List["_Span"] = []
_INTS: Dict[str, int] = {}
_TENSORS: Dict[str, List[torch.Tensor]] = {}
_RECORDS: List[Dict[str, Any]] = []


def enabled() -> bool:
    return _ON


def enable() -> None:
    global _ON
    with _LOCK:
        _ON = True


def disable() -> None:
    global _ON
    with _LOCK:
        _ON = False


def _stack() -> List["_Span"]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
        _LOCAL.thread = threading.get_native_id()
    return stack


class _Span:
    __slots__ = ("name", "attrs", "device", "id", "parent", "thread",
                 "start_ns", "end_ns", "events", "_rf")

    def __init__(self, name: str, device: bool, attrs: Dict[str, Any]):
        self.name, self.device, self.attrs = name, device, attrs
        self.events = self._rf = None

    def __enter__(self) -> "_Span":
        stack = _stack()
        self.id = next(_IDS)
        self.parent = stack[-1].id if stack else None
        self.thread = _LOCAL.thread
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        _stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        with _LOCK:
            _SPANS.append(self)


def span(name: str, device: bool = False,
         attrs: Optional[Dict[str, Any]] = None):
    """A context manager timing ``name`` (module docstring)."""
    if not _ON:
        return _NULL
    return _Span(name, device, dict(attrs or {}))


def annotate(**values) -> None:
    """Adds ``values`` to the attributes of this thread's innermost open
    span (for what is known only once the span has begun)."""
    if not _ON:
        return
    stack = _stack()
    if stack:
        stack[-1].attrs.update(values)


def count(name: str, value) -> None:
    """Adds ``value``, a Python int or a device tensor (kept unread), to
    the counter ``name``."""
    if not _ON:
        return
    with _LOCK:
        if isinstance(value, torch.Tensor):
            _TENSORS.setdefault(name, []).append(value.detach())
        else:
            _INTS[name] = _INTS.get(name, 0) + int(value)


def record(name: str, **fields) -> None:
    """Keeps one record of ``fields`` under ``name`` (a request's times)."""
    if not _ON:
        return
    with _LOCK:
        _RECORDS.append({"name": name, **fields})


def _device_ms(s: _Span) -> Optional[float]:
    return None if s.events is None else s.events[0].elapsed_time(
        s.events[1])


def drain() -> Dict[str, Any]:
    """Waits for the card once, then returns and clears what was recorded:
    ``spans`` (dicts in the order they closed; ``device_ms`` from the CUDA
    events, None where the span took none), ``counters`` (name -> int) and
    ``records``."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    global _SPANS, _INTS, _TENSORS, _RECORDS
    with _LOCK:
        spans, ints, tensors, records = _SPANS, _INTS, _TENSORS, _RECORDS
        _SPANS, _INTS, _TENSORS, _RECORDS = [], {}, {}, []
    counters = dict(ints)
    for name, values in tensors.items():
        total = int(torch.stack([v.reshape(()).to("cpu", torch.int64)
                                 for v in values]).sum())
        counters[name] = counters.get(name, 0) + total
    return {"spans": [{"name": s.name, "id": s.id, "parent": s.parent,
                       "thread": s.thread, "attrs": s.attrs,
                       "start_ns": s.start_ns, "end_ns": s.end_ns,
                       "device_ms": _device_ms(s)} for s in spans],
            "counters": counters, "records": records}
