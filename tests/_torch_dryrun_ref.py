"""The reference's side of ``tests/test_torch_dryrun*.py``: the JAX
package's own dry-run lowering (``repro.launch.dryrun._lower``) compiled on
a ('data', 'model') mesh of 4 host devices built with Auto axes, at the
cells' reduced shapes, printed as one JSON object:

    python tests/_torch_dryrun_ref.py train
    python tests/_torch_dryrun_ref.py prefill,decode

Each cell ``"arch/kind"`` holds the proof compile's ``memory_analysis()``
sizes and the depth-1 / depth-2 cost compiles' FLOPs; ``"skipped"`` is the
reference's ``run_cell`` record of a cell the assignment skips (it returns
before it builds a mesh).  ``main`` sets ``JAX_PLATFORMS=cpu`` and the
host device count before jax is imported.
"""
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO / "src") not in sys.path:
    sys.path.insert(0, str(REPO / "src"))

ARCHS = ["gemma-2b", "olmoe-1b-7b", "falcon-mamba-7b", "zamba2-2.7b"]
SEQ, BATCH = 32, 4
SKIPPED = ("gemma-2b", "long_500k")


def shape_of(kind):
    """The reduced shape of a cell of ``kind``, as a (name, kind, seq,
    batch) tuple both packages' ``ShapeCfg`` take."""
    return (f"{kind}_small", kind, SEQ, BATCH)


def reference(kinds):
    import jax
    import numpy as np
    from jax.sharding import Mesh

    import repro.launch.dryrun as jd
    from repro.configs import get_config
    from repro.configs.shapes import ShapeCfg

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    out = {"skipped": jd.run_cell(*SKIPPED, multi_pod=False, verbose=False)}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        for kind in kinds:
            shape = ShapeCfg(*shape_of(kind))
            ma = jd._lower(cfg, shape, mesh).compile().memory_analysis()
            rec = {"argument_bytes": ma.argument_size_in_bytes,
                   "output_bytes": ma.output_size_in_bytes}
            for n in (1, 2):
                c = jd._lower(jd._cost_cfg(cfg, n), shape, mesh).compile()
                rec[f"flops{n}"] = jd._extract(c)[0]
            out[f"{arch}/{kind}"] = rec
    return out


def port(kinds):
    """The port's side, in this process: each cell's step on fake tensors
    over a fake (2, 2) mesh on the CPU; its argument and output bytes, its
    output's leaves and the depth-1 / depth-2 FLOPs."""
    import torch

    import repro_torch.launch.dryrun as d
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCfg
    from repro_torch.tree import leaves

    dev = torch.device("cpu")
    out = {}
    with d._fake_world((2, 2), ("data", "model"), "cpu") as mesh:
        for arch in ARCHS:
            cfg = get_config(arch, smoke=True)
            for kind in kinds:
                shape = ShapeCfg(*shape_of(kind))
                rec = {f"flops{n}": d.count_cost(d._cost_cfg(cfg, n), shape,
                                                 mesh, dev).flops
                       for n in (1, 2)}
                fn, args = d._lower(cfg, shape, mesh, dev)
                res = fn(*args)
                rec.update(argument_bytes=d._local_bytes(args),
                           output_bytes=d._local_bytes(res),
                           output_leaves=len(leaves(res)))
                out[f"{arch}/{kind}"] = rec
    return out


def start_reference(kinds):
    """The reference's side in a subprocess, started now; ``result()``
    waits for it and returns its JSON."""
    import subprocess

    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), ",".join(kinds)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(REPO))

    def result():
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"reference failed:\n{stderr[-3000:]}")
        return json.loads(stdout.strip().splitlines()[-1])

    return result


def main(argv):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    print(json.dumps(reference(argv[0].split(","))))


if __name__ == "__main__":
    main(sys.argv[1:])
