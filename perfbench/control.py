"""Readings that set a cell's limits: the program, the control and the
faults, against the reference, on the chip at the cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 10] [--sound-only]

For each seed, one JSON line: the numbers ``judge`` compares for
- ``program``: the program as the cell runs it;
- ``control``: the reference in the program's place, its products
  through float8 (the precision below the configuration's bfloat16);
- each fault of ``faults.py`` the cell can have.
Training reads the checked steps alone (no window); serving runs a
window of ``--seconds`` at the cell's own load.  The benchmark's own
runs never run this.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def train_readings(run, sound_only: bool):
    from perfbench import bench, faults, judge, program
    from perfbench.kinds import train
    out = {}

    def program_side(hook=None):
        if hook is not None:
            run.hooks = {"train_step": hook(program.train_step(
                program.config(run.cell.conf))[0])}
        state, step, pool, readings = train.program_readings(
            run, bench.Spans(run.device, False))
        host = train.to_host(readings)
        del state, step, pool, readings
        bench.free()
        run.hooks = {}
        return host

    prog = program_side()
    half = None if sound_only else program_side(faults.half_batch)
    ref = train.reference_readings(run)
    bench.free()
    out["program"] = judge.training(prog, ref)
    detail = {"program": judge.training_detail(prog, ref)}
    if not sound_only:
        out["fault.half_batch"] = judge.training(half, ref)
        ctl = train.reference_readings(run, quant="fp8")
        bench.free()
        out["control"] = judge.training(ctl, ref)
        detail["fault.half_batch"] = judge.training_detail(half, ref)
        detail["control"] = judge.training_detail(ctl, ref)
    out["detail"] = detail
    return out


def serve_readings(run, sound_only: bool):
    from perfbench import faults
    from perfbench.kinds import serve
    out = {}
    res = serve.run(run)
    out["program"] = {n: c["value"] for n, c in res["checks"].items()}
    out["program"]["failed"] = res["failed"]
    if not sound_only:
        gaps = serve.reference_gaps(run, res["observed"]["judged"],
                                    quant="fp8")
        out["control"] = {"logit_gap": max(gaps)}
        for name, fault in sorted(faults.SERVE.items()):
            run.hooks = {"run_wave": fault(run.cell.conf["vocab_size"])}
            res = serve.run(run)
            run.hooks = {}
            out["fault." + name] = {n: c["value"]
                                    for n, c in res["checks"].items()}
            out["fault." + name]["failed"] = res["failed"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--sound-only", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import run as entry
    entry.set_caches(ROOT)
    import torch
    from perfbench import bench
    if not torch.cuda.is_available():
        print("perfbench control: no CUDA card", file=sys.stderr)
        return 3
    cell = bench.Cell.load(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        run = bench.Run(cell, seed, args.seconds, False, "cuda",
                        time.perf_counter())
        t0 = time.perf_counter()
        readings = (train_readings if cell.mix["kind"] == "train"
                    else serve_readings)(run, args.sound_only)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **readings}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
