"""Run one benchmark cell with the program's own tracer on, and print the
readings of ``perfbench/spans.py`` as the last line.

    python3 perfbench/program_trace.py --workload <cell> --seed <n> \
        --seconds <s> [--tracer 0|1]

The cell runs as ``run.py --trace 0`` runs it: the same set-up, window,
reference and checks.  Hooks around the program's train step (or wave)
turn the tracer (``repro_torch.runtime.trace``) on at the window's first
step (``--tracer 0`` leaves it off), profile the steps (or the wave) that
``run.py --trace 1`` profiles, and time every window step on the card
with CUDA events (a wave on the host clock).  ``by_span`` reads the
profile and the readers read it and what the tracer drained; the line
also gives the span coverage of the profile's device time and the
unprofiled steps' (or waves') times, whose difference between
``--tracer 1`` and ``--tracer 0`` runs on one card is the tracer's cost.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent

READERS = ("attention_ms", "attention_roofline", "mlp_ms",
           "moe_dispatch_ms", "moe_combine_ms", "moe_dropped", "prefill_ms",
           "decode_step_ms", "decode_idle", "pad_share", "ttft_s")


def tracer():
    """The program's tracer module."""
    from perfbench import program
    program._import()
    from repro_torch.runtime import trace
    return trace


class _Timer:
    """Window step times: CUDA events on a card, the host clock on the
    CPU (where a step ends with its work)."""

    def __init__(self, device):
        import torch
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if self.cuda:
            import torch
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)


class Hooks:
    """The hooks of one run (``bench.Run.hooks``) and what they saw."""

    def __init__(self, cell, device, on: bool):
        from perfbench.kinds import serve as serve_kind
        from perfbench.kinds import train as train_kind
        self.cell, self.device, self.on = cell, device, on
        self.kind = cell.mix["kind"]
        kind = train_kind if self.kind == "train" else serve_kind
        self.first = kind.PROFILE_FROM
        self.last = kind.PROFILE_FROM + (
            kind.PROFILE_STEPS if self.kind == "train"
            else kind.PROFILE_WAVES) - 1
        self.skip = cell.mix["check_steps"] if self.kind == "train" else 1
        self.calls = 0
        self.timer = _Timer(device)
        self.prof = None
        self.profile = None            # the profile, once it has ended
        self.window_s = 0.0
        self.profiled: List[int] = []
        self.times: List = []          # (window index, start, end)
        self.trace = tracer()

    def _sync(self):
        import torch
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def _around(self, fn, number_of):
        """``fn()`` as window step ``n``: the tracer on from the first,
        the profile over [first, last], each one timed."""
        from perfbench import bench
        n = self.calls - self.skip
        self.calls += 1
        if n < 0:
            return fn()
        if n == 0 and self.on:
            self.trace.enable()
        if n == self.first:
            self._sync()
            self.prof = bench.profile(self.device)
            self.prof.__enter__()
            self.p0 = time.perf_counter()
        a = self.timer.mark()
        out = fn()
        self.times.append((n, a, self.timer.mark()))
        if self.first <= n <= self.last:
            self.profiled.append(number_of(n))
        if n == self.last:
            self._sync()
            self.window_s = time.perf_counter() - self.p0
            self.prof.__exit__(None, None, None)
            self.profile, self.prof = self.prof, None
        return out

    def close(self):
        """Ends a profile the window cut short (it reads nothing)."""
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.prof = None

    def hooks(self) -> Dict:
        if self.kind == "train":
            from perfbench import program

            def train_step(cfg, opt):
                step = program.train_step(cfg)[0](cfg, opt)
                return lambda state, batch: self._around(
                    lambda: step(state, batch), lambda n: n)
            return {"train_step": train_step}

        def run_wave(engine):
            return self._around(engine.run_wave,
                                lambda n: engine.waves - 1)
        return {"run_wave": run_wave}

    def unprofiled_ms(self) -> List[float]:
        return [self.timer.ms(a, b) for n, a, b in self.times
                if not self.first <= n <= self.last]


def observe(cell, hooks: Hooks, program: Dict) -> Dict:
    """The observations the readers of ``perfbench/spans.py`` read."""
    from perfbench import bench, spans
    from perfbench import trace as ptrace
    mix, conf = cell.mix, cell.conf
    # read after the run, so that the export takes no time of the window
    events = (ptrace.events_of(hooks.profile) if hooks.profile is not None
              else [])
    summary = dict(ptrace.summarize(events), window_s=hooks.window_s,
                   spans=spans.by_span(events))
    obs = {"kind": hooks.kind, "device_kind": bench.device_kind(hooks.device),
           "trace": summary, "program": dict(program,
                                              profiled=hooks.profiled)}
    attention_flops = bench.family(conf).attention_flops
    if hooks.kind == "train" and attention_flops is not None:
        obs["attention_flops"] = mix["batch"] * attention_flops(
            conf, mix["seq_len"])
    return obs


def trace_cell(root: pathlib.Path, workload: str, seed: int,
               seconds: float, device: str, on: bool = True) -> Dict:
    """Run ``workload`` with the tracer ``on`` and return the line."""
    from perfbench import bench, spans
    cell = bench.Cell.load(root, workload)
    hooks = Hooks(cell, device, on)
    trace = hooks.trace
    trace.disable()
    trace.drain()
    try:
        result = bench.run_cell(root, workload, seed, seconds, False, device,
                                T_START, hooks.hooks())
    finally:
        trace.disable()
        hooks.close()
    program = trace.drain()
    obs = observe(cell, hooks, program)
    readings = {}
    for name in READERS:
        value = getattr(spans, name)(obs)
        if value is not None:
            readings[name] = value
    ms = hooks.unprofiled_ms()
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:12]]
    return {"workload": workload, "seed": seed, "tracer": on,
            "correct": result["correct"], "metrics": result["metrics"],
            "device": result["device"], "checks": result["checks"],
            "readings": readings,
            "coverage": spans.coverage(obs["trace"]["spans"]),
            "busy_s": obs["trace"]["busy_s"],
            "profiled_window_s": hooks.window_s,
            "unprofiled_ms": ms,
            "unprofiled_ms_median": statistics.median(ms) if ms else None,
            "counters": program["counters"],
            "by_span": top(obs["trace"]["spans"]["busy_s"]),
            "gaps_by_span": top(obs["trace"]["spans"]["gaps_s"]),
            "device_ops": obs["trace"]["device_ops"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import run
    run.set_caches(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("program_trace: needs a CUDA card", file=sys.stderr)
        return 3
    line = trace_cell(ROOT, args.workload, args.seed, args.seconds, "cuda",
                      bool(args.tracer))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
