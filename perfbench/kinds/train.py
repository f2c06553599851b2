"""Training traffic: the program's train step, back to back, on a pool of
batches drawn from the seed.

Set-up draws the weights, builds the program's train state and step,
and drives that same state through the mix's ``check_steps`` first steps
(which also warm up every shape).  After one step it reads each leaf's
clipped gradient from the optimizer's first moment; after the last it
reads each leaf's change, before the window's first step overwrites
the parameters.  The window then drives the same state on for
``--seconds``.  Once the window has closed and the program's state is
freed, the reference follows the checked steps from the same weights
and batches, with the plain reference of the configuration's model
family.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from perfbench import bench, flops, judge, program, trace, traffic, weights

PROFILE_FROM, PROFILE_STEPS = 1, 2


def batches(run: bench.Run, device) -> torch.Tensor:
    mix, conf = run.cell.mix, run.cell.conf
    return torch.as_tensor(
        traffic.train_batches(mix, conf["vocab_size"], run.seed),
        device=device)


def program_readings(run: bench.Run, spans: bench.Spans):
    """Set-up and the checked steps.  Returns (state, step, pool,
    readings) with the readings as device tensors."""
    conf, mix, dev = run.cell.conf, run.cell.mix, run.device
    cfg = program.config(conf)
    make_step, opt, train_state = program.train_step(cfg)
    if opt.name != mix["optimizer"]["name"]:
        raise ValueError(f"the program trains {cfg.name} with {opt.name}, "
                         f"the mix states {mix['optimizer']['name']}")
    opt = opt._replace(update=spans.wrap("optimizer", opt.update))
    params = weights.nest(weights.draw_all(conf, run.seed, dev))
    state = train_state(params=params, opt=opt.init(params),
                        step=torch.zeros((), dtype=torch.int32, device=dev))
    step = run.hooks.get("train_step", make_step)(cfg, opt)
    pool = batches(run, dev)
    losses, first = [], {}
    b1 = mix["optimizer"]["b1"]
    for j in range(mix["check_steps"]):
        state, metrics = step(state, feed(pool, j))
        losses.append(metrics["loss"])
        if j == 0:
            first = {n: torch.linalg.vector_norm(m.float()) / (1 - b1)
                     for n, m in weights.flatten(state.opt["m"]).items()}
    now = weights.flatten(state.params)
    change = {}
    with torch.no_grad():
        for i, leaf in enumerate(weights.leaves(conf)):
            start = weights.draw(leaf, i, run.seed, dev)
            change[leaf.path] = slice_norm(now[leaf.path], start)
            del start
    return state, step, pool, {"losses": losses, "first_grad": first,
                               "change": change}


def slice_norm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The float32 norm of ``a - b``, a layer of a stacked leaf at a
    time."""
    if a.dim() <= 2:
        return torch.linalg.vector_norm(a.float() - b.float())
    return torch.sqrt(sum(torch.linalg.vector_norm(x.float() - y.float()) ** 2
                          for x, y in zip(a, b)))


def feed(pool: torch.Tensor, j: int) -> Dict[str, torch.Tensor]:
    row = pool[j % pool.shape[0]]
    return {"tokens": row[:, :-1], "labels": row[:, 1:]}


def to_host(readings: Dict) -> Dict:
    return {"losses": [float(x) for x in readings["losses"]],
            "first_grad": {n: float(x)
                           for n, x in readings["first_grad"].items()},
            "change": {n: float(x) for n, x in readings["change"].items()}}


def reference_readings(run: bench.Run, quant=None) -> Dict:
    """The reference's readings over the checked steps, from the weights
    and batches of ``run.seed``."""
    conf, mix, dev = run.cell.conf, run.cell.mix, run.device
    table = weights.leaves(conf)
    index = {leaf.path: i for i, leaf in enumerate(table)}
    pool = batches(run, dev)
    fed = [feed(pool, j) for j in range(mix["check_steps"])]
    params = weights.draw_all(conf, run.seed, dev, torch.float32)
    reference = bench.family(conf).reference
    return reference.train(
        reference.Spec.from_config(conf), params,
        {leaf.path: leaf.dtype for leaf in table},
        [(b["tokens"], b["labels"]) for b in fed], mix["optimizer"],
        lambda n: weights.draw(table[index[n]], index[n], run.seed, dev,
                               torch.float32), quant)


def run(run: bench.Run) -> Dict:
    conf, mix, dev = run.cell.conf, run.cell.mix, run.device
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    spans = bench.Spans(dev, run.trace)
    state, step, pool, readings = program_readings(run, spans)
    run.sync()
    setup_s = time.perf_counter() - run.t_start
    run.before_window()

    # the window
    n_check, prof, summary = mix["check_steps"], None, None
    losses, profiled = [], set()
    n, t0 = 0, time.perf_counter()
    while True:
        if run.trace and n == PROFILE_FROM:
            run.sync()
            prof = bench.profile(dev)
            prof.__enter__()
            p0 = time.perf_counter()
        if prof is not None:
            profiled.add(n)
        spans.mark("step")
        state, metrics = step(state, feed(pool, n_check + n))
        losses.append(metrics["loss"])
        n += 1
        if prof is not None and n == PROFILE_FROM + PROFILE_STEPS:
            run.sync()
            summary = {"window_s": time.perf_counter() - p0}
            prof.__exit__(None, None, None)
            summary.update(trace.read(prof))
            prof = None
        if prof is None and time.perf_counter() - t0 >= run.seconds:
            break
    spans.mark("step")
    run.sync()
    window_s = time.perf_counter() - t0

    peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    prog = to_host(readings)
    observed = observe(run, spans, n, profiled, window_s, summary)
    del state, step, pool, readings, metrics, losses
    bench.free()

    t_ref = time.perf_counter()
    ref = reference_readings(run)
    bench.free()
    numbers = judge.training(prog, ref)
    bench.note(f"reference {time.perf_counter() - t_ref:.1f} s")
    tokens = mix["batch"] * mix["seq_len"]
    return {"ok": True, "attempted": n, "failed": failed,
            "memory_peak_bytes": peak,
            "end_to_end": {"train_tokens_per_s": n * tokens / window_s,
                           "setup_s": setup_s},
            "checks": judge.verdict(numbers, run.cell.limits),
            "observed": observed}


def observe(run: bench.Run, spans: bench.Spans, n: int, profiled, window_s,
            summary) -> Dict:
    """What the per-layer readers read: step, forward-and-backward and
    optimizer times of the unprofiled window steps (device timeline),
    the model FLOPs and optimizer bytes a step, the card's peaks."""
    conf, mix = run.cell.conf, run.cell.mix
    obs = {"kind": "train", "window_s": window_s, "steps": n,
           "trace": summary, "device_kind": bench.device_kind(run.device)}
    if spans.on:
        marks = spans.marks
        starts = marks["step"][-(n + 1):]
        opt0 = marks["optimizer.start"][-n:]
        opt1 = marks["optimizer.end"][-n:]
        keep = [i for i in range(n) if i not in profiled]
        obs["step_ms"] = [spans.ms(starts[i], starts[i + 1]) for i in keep]
        obs["fwd_bwd_ms"] = [spans.ms(starts[i], opt0[i]) for i in keep]
        obs["optimizer_ms"] = [spans.ms(opt0[i], opt1[i]) for i in keep]
    obs["step_flops"] = flops.train_step_flops(conf, mix["batch"],
                                               mix["seq_len"])
    obs["optimizer_bytes"] = flops.adamw_bytes(
        (int(torch.Size(leaf.shape).numel()), leaf.dtype.itemsize)
        for leaf in weights.leaves(conf))
    return obs
