"""Run one benchmark cell and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  With ``--trace 0`` the result carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from a profile
of a few steps inside the window.  Every run checks what the timed path
produced against the plain reference (``perfbench/reference``) and
prints each number compared beside its limit, as the last lines of
standard error and under ``checks`` in the result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# fixed directories inside the checkout for every kernel build cache
CACHES = {"TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def set_caches(root: pathlib.Path) -> None:
    for var, sub in CACHES.items():
        os.environ[var] = str(root / ".bench_cache" / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_caches(ROOT)
    sys.path.insert(0, str(ROOT))
    import torch
    from perfbench import bench

    cell = bench.Cell.load(ROOT, args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = bench.run_cell(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", T_START)
    found = bench.forbidden_modules(sys.modules)
    if found:
        print(f"perfbench: loaded in this process: {found}", file=sys.stderr)
        return 4
    bench.note(f"{args.workload} seed {args.seed}: run "
               f"{time.perf_counter() - T_START:.1f} s")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
