"""Quickstart: the paper's formalism in ~40 lines.

Takes one MnasNet layer, builds accelerators of increasing flexibility,
quantifies their flexion (H-F / W-F), and maps the layer on each with the
flexibility-constrained GA — reproducing the paper's core loop:
    flexibility spec -> map space -> constrained MSE -> runtime/energy.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
(on the CUDA card; ``main(device="cpu")`` runs it on the CPU)
"""
from ..core import (FULLFLEX, GAConfig, PARTFLEX, area_of, describe,
                    flexion_campaign, get_model, inflex_baseline,
                    make_variant, search)
from ..device import resolve_device


def main(argv=None, device=None):
    dev = resolve_device(device)
    # MnasNet "Layer 1": the stem conv (32, 3, 224, 224, 3, 3)
    layer = get_model("mnasnet")[0]
    print(f"workload: {layer.name} dims={layer.dims} "
          f"({layer.macs/1e6:.0f} MMACs)\n")

    accelerators = [
        inflex_baseline(),                        # class-0000, NVDLA-style
        make_variant("1000", PARTFLEX),           # hard-partitioned tile flex
        make_variant("1000", FULLFLEX),           # soft-partitioned tile flex
        make_variant("0010", FULLFLEX),           # parallelism flex
        make_variant("1111", FULLFLEX),           # MAERI-style, fully flexible
    ]

    ga = GAConfig(population=64, generations=40)
    base_runtime = None
    # all five flexion reports in one batched MC campaign (shared C_X
    # reference)
    flexions = flexion_campaign([(spec, layer, 0) for spec in accelerators],
                                mc_samples=20_000, device=dev)
    for spec, flexion in zip(accelerators, flexions):
        result = search(layer, spec, ga, device=dev)
        area = area_of(spec)
        base_runtime = base_runtime or result.runtime
        print(describe(spec))
        print(f"  flexion: {flexion}")
        print(f"  best mapping: T={result.mapping.tiles} "
              f"P={result.mapping.parallel} S={result.mapping.shape}")
        print(f"  runtime {result.runtime:.3g} cyc "
              f"({base_runtime / result.runtime:.2f}x vs InFlex), "
              f"util {result.util:.2f}, area +{area.overhead_pct:.2f}%\n")


if __name__ == "__main__":
    main()
