"""Serving traffic: a standing backlog of greedy requests, closed loop,
through the program's wave engine.

Set-up draws the weights, builds the engine and serves one warm wave.
The window keeps at least ``backlog`` requests queued and calls the
engine's ``run_wave`` until ``--seconds`` have passed; every wave the
window starts, it finishes, and every request a wave takes from the
queue has to come back finished.  Once the window has closed and the
program's state is freed, the plain reference of the configuration's
model family runs over a sample of the finished requests, drawn from
the seed with the longest prompt in it: each prompt as its wave served
it (left-padded with the engine's padding id to the wave's longest
prompt) followed by its served tokens, and the gap of each served
token's logit below the reference's best at that position is read.

The mix's ``qk_gain`` scales the query and key projections of the drawn
weights, so that attention is sharp and each served token depends on
the tokens served before it: a decode step that reads or writes the
wrong cache entries then changes what is served.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import bench, flops, judge, program, trace, traffic, weights
from perfbench.reference import common

PROFILE_FROM, PROFILE_WAVES = 1, 1
PAD_ID = 0


def sequences(results: List[Dict], sample: List[int]) -> List[Dict]:
    """Each sampled request's token sequence as its wave served it, and
    the first position whose logits chose a served token."""
    out = []
    for i in sample:
        r = results[i]
        pad = r["wave_len"] - len(r["prompt"])
        seq = np.concatenate([np.full(pad, PAD_ID, np.int64), r["prompt"],
                              r["tokens"][:-1].astype(np.int64)])
        out.append({"tokens": seq, "first": r["wave_len"] - 1,
                    "served": r["tokens"].astype(np.int64)})
    return out


def reference_gaps(run: bench.Run, seqs: List[Dict], quant=None
                   ) -> List[float]:
    """For each position of each sequence, how far the float32
    reference's logit of the chosen token lies below its best.  The
    chosen token is the served one, or with ``quant`` the one the
    reference in that precision puts first."""
    conf, dev = run.cell.conf, run.device
    reference = bench.family(conf).reference
    common.no_tf32()
    spec = reference.Spec.from_config(conf)
    params = weights.draw_all(conf, run.seed, dev, torch.float32,
                              run.cell.mix.get("qk_gain", 1.0))
    gaps = []
    for s in seqs:
        toks = torch.as_tensor(s["tokens"], device=dev)
        ref = reference.logits_at(spec, params, toks, s["first"])
        if quant is None:
            chosen = torch.as_tensor(s["served"], device=dev)
        else:
            chosen = reference.logits_at(spec, params, toks, s["first"],
                                         quant).argmax(-1)
        best = ref.max(-1).values
        gaps.extend((best - ref.gather(1, chosen[:, None])[:, 0]).tolist())
    return gaps


def sample_of(run: bench.Run, results: List[Dict]) -> List[int]:
    """Indices of ``check_requests`` finished requests, drawn from the
    seed, the one with the longest prompt always among them."""
    n = min(run.cell.mix["check_requests"], len(results))
    longest = max(range(len(results)), key=lambda i: len(results[i]["prompt"]))
    others = [i for i in range(len(results)) if i != longest]
    pick = traffic.rng(run.seed, 2).permutation(others)[:n - 1]
    return sorted([longest, *map(int, pick)])


def run(run: bench.Run) -> Dict:
    conf, mix, dev = run.cell.conf, run.cell.mix, run.device
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cfg = program.config(conf)
    engine_cls, request_cls = program.serve_engine()
    params = weights.nest(weights.draw_all(conf, run.seed, dev,
                                           qk_gain=mix.get("qk_gain", 1.0)))
    engine = engine_cls(cfg, params, max_batch=mix["wave_size"],
                        max_len=mix["max_len"], seed=run.seed)
    run_wave = run.hooks.get("run_wave", lambda e: e.run_wave())
    pool = traffic.serve_requests(mix, conf["vocab_size"], run.seed)
    submitted = [0]

    def top_up():
        while len(engine.queue) < mix["backlog"]:
            r = pool[submitted[0] % len(pool)]
            engine.submit(request_cls(uid=submitted[0], prompt=r["prompt"],
                                      max_new_tokens=r["max_new_tokens"]))
            submitted[0] += 1

    top_up()
    run_wave(engine)            # the warm wave
    run.sync()
    setup_s = time.perf_counter() - run.t_start
    run.before_window()

    results, spans, profiled, lost = [], [], set(), 0
    prof, summary, w = None, None, 0
    t0 = time.perf_counter()
    while True:
        top_up()
        if run.trace and w == PROFILE_FROM:
            run.sync()
            prof = bench.profile(dev)
            prof.__enter__()
            p0 = time.perf_counter()
        if prof is not None:
            profiled.add(w)
        queued = {r.uid for r in engine.queue}
        s0 = time.perf_counter()
        done = run_wave(engine)
        spans.append(time.perf_counter() - s0)
        taken = queued - {r.uid for r in engine.queue}
        lost += len(taken - {d.uid for d in done})
        wave_len = max(len(pool[uid % len(pool)]["prompt"])
                       for uid in taken)
        for d in done:
            results.append({"uid": d.uid, "wave": w, "wave_len": wave_len,
                            "prompt": pool[d.uid % len(pool)]["prompt"],
                            "tokens": np.asarray(d.tokens),
                            "error": d.error})
        w += 1
        if prof is not None and w == PROFILE_FROM + PROFILE_WAVES:
            run.sync()
            summary = {"window_s": time.perf_counter() - p0}
            prof.__exit__(None, None, None)
            summary.update(trace.read(prof))
            prof = None
        if prof is None and time.perf_counter() - t0 >= run.seconds:
            break
    run.sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    new = mix["new_tokens"]
    good = [r for r in results
            if r["error"] is None and len(r["tokens"]) == new]
    served = sum(len(r["prompt"]) + len(r["tokens"]) for r in good)
    observed = {
        "kind": "serve", "window_s": window_s, "trace": summary,
        "device_kind": bench.device_kind(dev),
        "wave_s": [s for i, s in enumerate(spans) if i not in profiled],
        "wave_flops": [sum(flops.serve_request_flops(conf, len(r["prompt"]),
                                                      len(r["tokens"]))
                           for r in good if r["wave"] == i)
                       for i in range(w) if i not in profiled],
    }
    del engine, params
    bench.free()

    ok = len(good) == len(results) and len(good) > 0 and not lost
    t_ref = time.perf_counter()
    if good:
        observed["judged"] = sequences(good, sample_of(run, good))
        numbers = judge.serving(reference_gaps(run, observed["judged"]))
    else:
        observed["judged"] = []
        numbers = {"logit_gap": float("inf")}
    bench.note(f"reference {time.perf_counter() - t_ref:.1f} s")
    return {"ok": ok, "attempted": len(results) + lost,
            "failed": len(results) - len(good) + lost,
            "memory_peak_bytes": peak,
            "end_to_end": {"serve_tokens_per_s": served / window_s,
                           "setup_s": setup_s},
            "checks": judge.verdict(numbers, run.cell.limits),
            "observed": observed}
