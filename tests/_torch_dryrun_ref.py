"""The reference's side of ``tests/test_torch_dryrun*.py``: the JAX
package's own dry-run lowering (``repro.launch.dryrun._lower``) compiled on
a ('data', 'model') mesh of 4 host devices built with Auto axes (2x2
unless a mesh shape and the archs are given), at the cells' reduced
shapes, printed as one JSON object:

    python tests/_torch_dryrun_ref.py train
    python tests/_torch_dryrun_ref.py prefill,decode
    python tests/_torch_dryrun_ref.py decode 1x4 falcon-mamba-7b,gemma-2b

Each cell ``"arch/kind"`` holds the proof compile's ``memory_analysis()``
sizes and the depth-1 / depth-2 cost compiles' FLOPs, all of them and
their dots' alone; ``"skipped"`` is the
reference's ``run_cell`` record of a cell the assignment skips (it returns
before it builds a mesh).  ``main`` sets ``JAX_PLATFORMS=cpu`` and the
host device count before jax is imported.
"""
import json
import math
import os
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO / "src") not in sys.path:
    sys.path.insert(0, str(REPO / "src"))

ARCHS = ["gemma-2b", "olmoe-1b-7b", "falcon-mamba-7b", "zamba2-2.7b"]
SEQ, BATCH = 32, 4
SKIPPED = ("gemma-2b", "long_500k")

# The port's per-device FLOPs over XLA's: the train cells against
# ``cost_analysis()["flops"]``, which counts elementwise ops too where the
# port's registry counts matmuls, attention and convolutions only (0.608
# for falcon-mamba-7b, whose scan is elementwise, to 1.077); the prefill
# and decode cells against the FLOPs of the partitioned HLO's dots
# (``dot_flops``), which the port's equal exactly but for the MoE decode:
# it routes and scatters the whole tokens on every rank and runs its
# experts on every slot (1.651–1.729).
FLOP_BAND = (0.6, 1.75)
# the one prefill or decode cell whose matmuls replicate over 'model'
REPLICATED = "olmoe-1b-7b/decode"
_DEF = re.compile(r"^\s*(?:ROOT )?(%[\w.\-]+) = \w+\[([\d,]*)\]")
_DOT = re.compile(r"= \w+\[([\d,]*)\]\S* dot\((%[\w.\-]+), %[\w.\-]+\)"
                  r".*?lhs_contracting_dims=\{([\d,]*)\}")


def dot_flops(hlo: str) -> int:
    """The FLOPs of every dot in a compiled module's HLO text, one
    device's: 2 x the output's size x the contracted size, the operands'
    shapes read from their definitions."""
    def dims(text):
        return [int(x) for x in text.split(",") if x]

    shapes = {m.group(1): dims(m.group(2))
              for m in map(_DEF.match, hlo.splitlines()) if m}
    total = 0
    for m in filter(None, map(_DOT.search, hlo.splitlines())):
        lhs = shapes[m.group(2)]
        total += 2 * math.prod(dims(m.group(1))) * math.prod(
            lhs[d] for d in dims(m.group(3)))
    return total


def shape_of(kind):
    """The reduced shape of a cell of ``kind``, as a (name, kind, seq,
    batch) tuple both packages' ``ShapeCfg`` take."""
    return (f"{kind}_small", kind, SEQ, BATCH)


def reference(kinds, mesh_shape=(2, 2), archs=ARCHS):
    import jax
    import numpy as np
    from jax.sharding import Mesh

    import repro.launch.dryrun as jd
    from repro.configs import get_config
    from repro.configs.shapes import ShapeCfg

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(mesh_shape),
                ("data", "model"))
    out = {"skipped": jd.run_cell(*SKIPPED, multi_pod=False, verbose=False)}
    for arch in archs:
        cfg = get_config(arch, smoke=True)
        for kind in kinds:
            shape = ShapeCfg(*shape_of(kind))
            ma = jd._lower(cfg, shape, mesh).compile().memory_analysis()
            rec = {"argument_bytes": ma.argument_size_in_bytes,
                   "output_bytes": ma.output_size_in_bytes}
            for n in (1, 2):
                c = jd._lower(jd._cost_cfg(cfg, n), shape, mesh).compile()
                rec[f"flops{n}"] = jd._extract(c)[0]
                rec[f"dots{n}"] = dot_flops(c.as_text())
            out[f"{arch}/{kind}"] = rec
    return out


def port(kinds, mesh_shape=(2, 2), archs=ARCHS):
    """The port's side, in this process: each cell's step on fake tensors
    over a fake mesh of ``mesh_shape`` on the CPU; its argument and output
    bytes, its output's leaves and the depth-1 / depth-2 FLOPs."""
    import torch

    import repro_torch.launch.dryrun as d
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeCfg
    from repro_torch.tree import leaves

    dev = torch.device("cpu")
    out = {}
    with d._fake_world(mesh_shape, ("data", "model"), "cpu") as mesh:
        for arch in archs:
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


def start_reference(kinds, mesh_shape=(2, 2), archs=ARCHS):
    """The reference's side in a subprocess, started now; ``result()``
    waits for it and returns its JSON."""
    import subprocess

    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), ",".join(kinds),
         "x".join(map(str, mesh_shape)), ",".join(archs)],
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
    mesh_shape = (tuple(int(n) for n in argv[1].split("x"))
                  if len(argv) > 1 else (2, 2))
    archs = argv[2].split(",") if len(argv) > 2 else ARCHS
    print(json.dumps(reference(argv[0].split(","), mesh_shape, archs)))


if __name__ == "__main__":
    main(sys.argv[1:])
