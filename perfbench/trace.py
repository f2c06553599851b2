"""Reading a ``torch.profiler`` trace of a few steps inside the window.

The profile is exported as a Chrome trace into ``TMPDIR`` and read back:
device busy time (the union of kernel, copy and set intervals), the
device operations that took most time, and the idle gaps between them,
each named by the innermost host event (an operator or a CUDA runtime
call) that was running when the gap began.
"""
from __future__ import annotations

import collections
import json
import os
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def events_of(prof) -> List[Dict]:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _union(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _host_names(host: List[Tuple[float, float, str]],
                times: List[float]) -> List[str]:
    """For each of the sorted ``times``, the innermost (shortest) host
    event that spans it: one sweep over the host events, sorted by
    start."""
    out, active, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= t]
        out.append(min(active, key=lambda h: h[1] - h[0])[2] if active
                   else "(no host op)")
    return out


def read(prof) -> Dict:
    """``summarize`` of a finished profile."""
    return summarize(events_of(prof))


def summarize(events: List[Dict]) -> Dict:
    """``busy_s`` (device busy, seconds), ``span_s`` (first device start
    to last device end), ``device_ops`` and ``idle_gaps`` ([name,
    seconds], the ``TOP`` largest), ``kernels`` (count)."""
    dev = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not dev:
        return {"busy_s": 0.0, "span_s": 0.0, "device_ops": [],
                "idle_gaps": [], "kernels": 0}
    busy = _union([(a, b) for a, b, _ in dev])
    by_name: Dict[str, float] = collections.defaultdict(float)
    for a, b, name in dev:
        by_name[name[:120]] += (b - a) / 1e6
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"][:120])
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS)
    gaps: Dict[str, float] = collections.defaultdict(float)
    ends = [b for _, b in busy[:-1]]
    for name, end, (start, _) in zip(_host_names(host, ends), ends,
                                     busy[1:]):
        gaps[name] += (start - end) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": sum(b - a for a, b in busy) / 1e6,
            "span_s": (busy[-1][1] - busy[0][0]) / 1e6,
            "device_ops": top(by_name), "idle_gaps": top(gaps),
            "kernels": len(dev)}
