"""Beyond-paper: the TOPS formalism applied to the pod itself.

The paper's axes map onto distributed-training knobs (DESIGN.md §3):
S = logical mesh shape, P = sharding rules, T = microbatch/block sizes,
O = scan order / stationarity.  This example runs the same constrained-GA
DSE over *mesh shapes x sharding choices* for one assigned architecture,
scoring candidates with the chip-level roofline model — i.e. the paper's
flexibility-aware DSE reused as an auto-sharding tool.

Run:  PYTHONPATH=src python -m repro_torch.examples.autoshard_tops --arch gemma-2b
(needs the CUDA card, as every entry point of the port does, though the
roofline model runs on the host; ``main(argv, device="cpu")`` runs it
without one)
"""
import argparse

from ..core.tops_bridge import autoshard_report
from ..device import resolve_device


def main(argv=None, device=None):
    resolve_device(device)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--chips", type=int, default=256)
    args = ap.parse_args(argv)
    return autoshard_report(args.arch, args.shape, n_chips=args.chips)


if __name__ == "__main__":
    main()
