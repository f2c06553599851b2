"""Device time by the program's own spans, and the per-layer readers of
what the program's tracer recorded.

The program (``repro_torch.runtime.trace``) opens each span as a
``torch.profiler.record_function("repro_torch.<name>")``, so a profile
holds it as a ``user_annotation`` on the clock of the kernels.
``by_span`` puts each kernel, copy and set of a profile down to the
innermost such span: through its ``correlation`` id to the runtime call
that launched it, and from that call's thread and time to the innermost
span open there.  A backward op has no span of its own: its kernels go
through the profiler's ``fwdbwd`` flow, from the backward op back to the
forward op that made its autograd node, to the span that held that
forward op (remat's backward nodes link to the first forward; the
replay runs inside its own spans on autograd's thread, and those win
where they lie inside the backward op).  The link covers the autograd
engine's whole ``evaluate_function`` of the node, so the sums of
gradients that the engine adds after the node's call go with it.  A launch with neither goes to
the innermost span open on any thread (the step waiting for autograd).
Each idle gap goes to the innermost span open, on any thread, when the
gap began.  On a profile with no device activity (the CPU), each host
operator's self time stands in for a kernel, launched by itself.

A reader takes a run's observations and returns the metric, or None
where the run gives it nothing to read.  The observations it reads:
``trace["spans"]`` (``by_span`` of the profile), ``program`` (the
tracer's ``drain()`` plus ``profiled``, the window steps or the engine's
wave numbers inside the profile), ``attention_flops`` (a step's forward
attention FLOPs) and ``device_kind``.
"""
from __future__ import annotations

import bisect
import collections
import statistics
from typing import Dict, List, Optional, Tuple

from perfbench import flops
from perfbench.trace import DEVICE_CATS, _union

PREFIX = "repro_torch."
ENGINE = "autograd::engine::evaluate_function:"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
NONE = "(none)"

Interval = Tuple[float, float, object]


def _thread(e: Dict) -> Tuple:
    return (e.get("pid"), e.get("tid"))


def _innermost(intervals: List[Interval], times: List[float]
               ) -> List[Optional[Interval]]:
    """For each of the sorted ``times``, the innermost of the nested
    ``intervals`` (start, end, value) that holds it, or None: one sweep
    with a stack of the open intervals."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ivs) and ivs[i][0] <= t:
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def _lookup(by_thread: Dict[Tuple, List[Interval]],
            points: List[Tuple[Tuple, float]]) -> List[Optional[Interval]]:
    """``_innermost`` of each (thread, time) point among that thread's
    intervals, in the points' order."""
    out: List[Optional[Interval]] = [None] * len(points)
    asked = collections.defaultdict(list)
    for k, (thread, t) in enumerate(points):
        asked[thread].append((t, k))
    for thread, qs in asked.items():
        qs.sort()
        found = _innermost(by_thread.get(thread, []), [t for t, _ in qs])
        for (_, k), iv in zip(qs, found):
            out[k] = iv
    return out


def _any_thread(by_thread: Dict[Tuple, List[Interval]],
                times: List[float]) -> List[Optional[Interval]]:
    """For each time, the shortest interval holding it on any thread."""
    best: List[Optional[Interval]] = [None] * len(times)
    order = sorted(range(len(times)), key=times.__getitem__)
    for ivs in by_thread.values():
        found = _innermost(ivs, [times[k] for k in order])
        for k, iv in zip(order, found):
            if iv is not None and (best[k] is None or iv[1] - iv[0]
                                   < best[k][1] - best[k][0]):
                best[k] = iv
    return best


def _end(e: Dict) -> float:
    return e["ts"] + e.get("dur", 0)


def _self_times(ops: List[Dict]) -> List[Tuple[Tuple, float, float]]:
    """(thread, start, self seconds) of each host operator: its duration
    less its direct children's."""
    out = []
    by_thread = collections.defaultdict(list)
    for e in ops:
        by_thread[_thread(e)].append(e)
    for thread, es in by_thread.items():
        es.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        self_us = [float(e.get("dur", 0)) for e in es]
        stack: List[int] = []
        for k, e in enumerate(es):
            while stack and _end(es[stack[-1]]) < e["ts"]:
                stack.pop()
            if stack:
                self_us[stack[-1]] -= e.get("dur", 0)
            stack.append(k)
        out.extend((thread, e["ts"], max(us, 0.0) / 1e6)
                   for e, us in zip(es, self_us))
    return out


def _overlap(a: List[List[float]], b: List[List[float]]) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, j = 0.0, 0
    starts = [x for x, _ in b]
    for lo, hi in a:
        j = max(bisect.bisect_right(starts, lo) - 1, 0)
        while j < len(b) and b[j][0] < hi:
            total += max(0.0, min(hi, b[j][1]) - max(lo, b[j][0]))
            j += 1
    return total


def _backward(events: List[Dict], cpu_ops: List[Dict]
              ) -> Dict[Tuple, List[Interval]]:
    """By thread, the backward ops' intervals (start, end, the forward
    op's (thread, time)): the operator at each ``fwdbwd`` flow's end,
    widened to the engine's ``evaluate_function`` around it, linked to
    the operator at the flow's start."""
    flows = collections.defaultdict(dict)
    for e in events:
        if e.get("cat") == "fwdbwd" and e.get("ph") in ("s", "f"):
            flows[e.get("id")][e["ph"]] = (_thread(e), e["ts"])
    op_at: Dict[Tuple, Dict] = {}
    engine = collections.defaultdict(list)
    for e in cpu_ops:      # of two starting together, the outer one
        at = (_thread(e), e["ts"])
        if at not in op_at or e.get("dur", 0) > op_at[at].get("dur", 0):
            op_at[at] = e
        if e["name"].startswith(ENGINE):
            engine[at[0]].append((e["ts"], _end(e), None))
    linked = [(op_at[f["f"]], f["s"]) for f in flows.values()
              if "s" in f and f.get("f") in op_at]
    around = _lookup(engine, [(_thread(op), op["ts"]) for op, _ in linked])
    backward = collections.defaultdict(list)
    for (op, fwd), w in zip(linked, around):
        start, end = (w[0], w[1]) if w else (op["ts"], _end(op))
        backward[_thread(op)].append((start, end, fwd))
    return backward


def by_span(events: List[Dict]) -> Dict:
    """Seconds of device work (``busy_s``) and of idle gaps (``gaps_s``)
    by innermost program span, ``(none)`` for what no span holds; and,
    for each span name, its host seconds (``span_s``, all its spans,
    their union) and the idle seconds inside them (``idle_in_s``)."""
    xs = [e for e in events if e.get("ph") == "X"]
    spans = collections.defaultdict(list)
    for e in xs:
        if e.get("cat") == "user_annotation" and \
                e["name"].startswith(PREFIX):
            spans[_thread(e)].append((e["ts"], _end(e),
                                      e["name"][len(PREFIX):]))
    cpu_ops = [e for e in xs if e.get("cat") == "cpu_op"]
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    if device:
        launched_by = {e["args"]["correlation"]: (_thread(e), e["ts"])
                       for e in xs if e.get("cat") in RUNTIME_CATS
                       and "correlation" in e.get("args", {})}
        work = [(launched_by.get(e.get("args", {}).get("correlation")),
                 e.get("dur", 0) / 1e6) for e in device]
    else:
        work = [((thread, ts), s) for thread, ts, s in _self_times(cpu_ops)]

    backward = _backward(events, cpu_ops)
    launched = [(k, pos) for k, (pos, _) in enumerate(work) if pos]
    own = _lookup(spans, [pos for _, pos in launched])
    bwd = _lookup(backward, [pos for _, pos in launched])
    names: List[Optional[str]] = [None] * len(work)
    via_fwd = []
    for (k, pos), s, b in zip(launched, own, bwd):
        if b is not None and (s is None or b[0] >= s[0]):
            via_fwd.append((k, b[2], s))
        elif s is not None:
            names[k] = s[2]
    fwd = _lookup(spans, [p for _, p, _ in via_fwd])
    for (k, _, s), f in zip(via_fwd, fwd):
        held = f or s
        names[k] = held[2] if held else None
    loose = [k for k, _ in launched if names[k] is None]
    for k, iv in zip(loose, _any_thread(spans, [work[k][0][1]
                                                for k in loose])):
        names[k] = iv[2] if iv else None

    busy_s: Dict[str, float] = collections.defaultdict(float)
    for name, (_, sec) in zip(names, work):
        busy_s[name or NONE] += sec
    out = {"busy_s": dict(busy_s), "gaps_s": {}, "span_s": {},
           "idle_in_s": {}}
    if not device:
        return out
    busy = _union([(e["ts"], _end(e)) for e in device])
    starts = [b for _, b in busy[:-1]]
    gaps: Dict[str, float] = collections.defaultdict(float)
    for (end, (start, _)), iv in zip(zip(starts, busy[1:]),
                                     _any_thread(spans, starts)):
        gaps[iv[2] if iv else NONE] += (start - end) / 1e6
    out["gaps_s"] = dict(gaps)
    by_name = collections.defaultdict(list)
    for ivs in spans.values():
        for a, b, name in ivs:
            by_name[name].append((a, b))
    for name, ivs in by_name.items():
        held = _union(ivs)
        length = sum(b - a for a, b in held)
        out["span_s"][name] = length / 1e6
        out["idle_in_s"][name] = (length - _overlap(held, busy)) / 1e6
    return out


def coverage(spans: Dict) -> Optional[float]:
    """Share of device work that some program span holds, %."""
    total = sum(spans["busy_s"].values())
    if total <= 0:
        return None
    return 100.0 * (1.0 - spans["busy_s"].get(NONE, 0.0) / total)


# ---------------------------------------------------------------- readers

def _busy_ms_a_step(obs: Dict, *names: str) -> Optional[float]:
    spans = (obs.get("trace") or {}).get("spans")
    program = obs.get("program")
    if not spans or not program or not program.get("profiled"):
        return None
    if not any(n in spans["busy_s"] for n in names):
        return None
    return 1e3 * sum(spans["busy_s"].get(n, 0.0) for n in names) \
        / len(program["profiled"])


def attention_ms(obs: Dict) -> Optional[float]:
    """Device self time of ``attn.core`` a profiled step: forward, remat
    replay and backward."""
    return _busy_ms_a_step(obs, "attn.core")


def attention_roofline(obs: Dict) -> Optional[float]:
    """Forward and backward attention FLOPs a step (3x the forward's) at
    the bfloat16 peak, over ``attention_ms``."""
    ms = attention_ms(obs)
    peak = flops.peak(obs.get("device_kind", ""), "bf16_flops")
    if ms is None or peak is None or not obs.get("attention_flops"):
        return None
    return 100.0 * (3 * obs["attention_flops"] / peak) / (ms / 1e3)


def mlp_ms(obs: Dict) -> Optional[float]:
    """Device self time of the dense ``mlp`` a profiled step."""
    return _busy_ms_a_step(obs, "mlp")


def moe_dispatch_ms(obs: Dict) -> Optional[float]:
    """Device self time of ``moe.route`` and ``moe.dispatch`` a step."""
    return _busy_ms_a_step(obs, "moe.route", "moe.dispatch")


def moe_combine_ms(obs: Dict) -> Optional[float]:
    """Device self time of ``moe.combine`` a step."""
    return _busy_ms_a_step(obs, "moe.combine")


def _counters(obs: Dict) -> Dict:
    return (obs.get("program") or {}).get("counters") or {}


def moe_dropped(obs: Dict) -> Optional[float]:
    """Assignments ranked past their expert's capacity, % of all (a
    ratio, so the remat replay's second count cancels)."""
    c = _counters(obs)
    if not c.get("moe.assignments"):
        return None
    return 100.0 * c.get("moe.dropped", 0) / c["moe.assignments"]


def pad_share(obs: Dict) -> Optional[float]:
    """Prefill positions that are padding, % of all."""
    c = _counters(obs)
    if not c.get("serve.prefill_positions"):
        return None
    return 100.0 * (1.0 - c["serve.prompt_tokens"]
                    / c["serve.prefill_positions"])


def _waves(obs: Dict) -> Tuple[Dict[int, Dict], List[Dict], set]:
    """(span by id, spans, ids of the profiled waves' serve.wave spans)."""
    program = obs.get("program") or {}
    spans = program.get("spans") or []
    by_id = {s["id"]: s for s in spans}
    profiled = set(program.get("profiled") or ())
    hot = {s["id"] for s in spans if s["name"] == "serve.wave"
           and s["attrs"].get("wave") in profiled}
    return by_id, spans, hot


def prefill_ms(obs: Dict) -> Optional[float]:
    """Mean device ms of ``serve.prefill``, waves outside the profile."""
    _, spans, hot = _waves(obs)
    ms = [s["device_ms"] for s in spans if s["name"] == "serve.prefill"
          and s["parent"] not in hot and s["device_ms"] is not None]
    return statistics.fmean(ms) if ms else None


def decode_step_ms(obs: Dict) -> Optional[float]:
    """Mean host ms from a ``serve.decode`` start to the end of the
    ``serve.sample`` after it, waves outside the profile."""
    _, spans, hot = _waves(obs)
    steps = collections.defaultdict(list)
    for s in spans:
        if s["name"] in ("serve.decode", "serve.sample") \
                and s["parent"] not in hot:
            steps[s["parent"]].append(s)
    ms = []
    for kids in steps.values():
        kids.sort(key=lambda s: s["start_ns"])
        ms.extend((b["end_ns"] - a["start_ns"]) / 1e6
                  for a, b in zip(kids, kids[1:])
                  if a["name"] == "serve.decode"
                  and b["name"] == "serve.sample")
    return statistics.fmean(ms) if ms else None


def decode_idle(obs: Dict) -> Optional[float]:
    """Share of the profiled wave's ``serve.decode`` and ``serve.sample``
    time with nothing on the card, %."""
    spans = (obs.get("trace") or {}).get("spans")
    names = ("serve.decode", "serve.sample")
    if not spans or not all(n in spans["span_s"] for n in names):
        return None
    return 100.0 * sum(spans["idle_in_s"][n] for n in names) \
        / sum(spans["span_s"][n] for n in names)


def ttft_s(obs: Dict) -> Optional[float]:
    """Median host seconds from a request's submit to its first token,
    over the requests submitted while traced whose wait did not overlap
    a profiled wave."""
    by_id, _, hot = _waves(obs)
    busy = [(by_id[i]["start_ns"], by_id[i]["end_ns"]) for i in hot]
    records = (obs.get("program") or {}).get("records") or []
    waits = [(r["first_token_ns"] - r["submit_ns"]) / 1e9 for r in records
             if r.get("name") == "serve.request" and r["submit_ns"]
             and r["first_token_ns"]
             and not any(a < r["first_token_ns"] and r["submit_ns"] < b
                         for a, b in busy)]
    return statistics.median(waits) if waits else None
