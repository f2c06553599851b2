"""The paper's Sec-7 'what-if': a 2014 AlexNet-optimized accelerator meets
2020s workloads (BERT, DLRM, NCF...).  How much does design-time flexibility
future-proof it?

Class strings here are 5-axis: a trailing fifth character drives the
representation (bit-width) axis, e.g. "11111" opens T/O/P/S *and* R.  The
fig13 bench sweeps the full 2^5 = 32-class taxonomy
(``repro_torch.bench.fig13_futureproof.CLASSES_5AXIS``); this example keeps
a small contrast set.

Run:  PYTHONPATH=src python -m repro_torch.examples.futureproof_whatif
(on the CUDA card; ``main(device="cpu")`` runs it on the CPU)
"""
from ..core import GAConfig, future_proofing_study, geomean_speedup
from ..device import resolve_device

MODELS = ("alexnet", "mnasnet", "bert", "dlrm", "ncf")


def main(argv=None, device=None):
    dev = resolve_device(device)
    models = MODELS
    table = future_proofing_study(
        base_model="alexnet", future_models=models,
        class_strs=("1000", "0010", "1111", "11111"),
        cfg=GAConfig(population=48, generations=24), device=dev)

    print(f"{'accel':34s}" + "".join(f"{m:>12s}" for m in models)
          + f"{'geomean x':>12s}")
    for row, cols in table.items():
        gm = geomean_speedup(table, row)
        print(f"{row:34s}" + "".join(f"{cols[m]:12.3f}" for m in models)
              + f"{gm:12.2f}")

    future = [m for m in models if m != "alexnet"]
    # exact row name: startswith would also match the R-open FullFlex11111
    # row
    full_row = "FullFlex1111-alexnet-Opt"
    gm = geomean_speedup(table, full_row, future)
    print(f"\nFullFlex-1111 future-proofing geomean on future models: "
          f"{gm:.1f}x  (paper reports 11.8x over its 7-model suite)")
    full5_row = "FullFlex11111-alexnet-Opt"
    gm5 = geomean_speedup(table, full5_row, future)
    print(f"FullFlex-11111 (R axis open too): {gm5:.1f}x")
    return table


if __name__ == "__main__":
    main()
