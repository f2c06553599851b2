"""Multi-pod dry-run, the counterpart of ``repro/launch/dryrun.py``: run
every (architecture x input-shape x mesh) cell's sharded step once on fake
tensors over a fake process group, and extract the per-device memory and
the roofline terms from that run.

  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k [--multipod]
  python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl
  python -m repro_torch.launch.dryrun --arch whisper-base --shape train_4k --device cpu

Nothing is compiled and nothing is allocated: the mesh is a ``DeviceMesh``
of the cell's shape (16x16, 2x16x16 or ``--mesh-shape``) over a process
group of the package's own fake backend, this process its rank 0, and the
step's tensors are ``FakeTensor``s (shapes, dtypes and a device, no
storage) inside ``DTensor``s.  The fake tensors name the card's device
type unless ``--device cpu`` is given; without a card, asking for it
raises.  The dry-run launches no kernel.

Two runs per single-pod cell, as the reference's two compiles:

  PROOF  the production config's sharded step (``jit_train_step``,
         ``jit_prefill_step`` or ``jit_serve_step``) once: it proves the
         sharding runs and gives the memory.  ``argument_bytes`` /
         ``output_bytes`` are rank 0's local shard bytes of the inputs /
         outputs (rank 0 holds the largest shard); ``temp_bytes`` is the
         step's peak live bytes (``MemTracker``) less the arguments;
         ``peak_bytes = argument + temp``.  ``compile_s`` is this run's
         wall seconds: the port compiles nothing.
  COST   the depth-1 and depth-2 clones of ``_cost_cfg`` run under
         ``hloutil.CostRecorder`` (FLOPs, bytes accessed and collective
         bytes, per device), linearly extrapolated to the full depth:
         C(L) = C(1) + (L-1)·ΔC.

Multi-pod cells run the PROOF only (the roofline table is single-pod).
Hardware: NVIDIA H100 SXM5 data-sheet rates (``hloutil``).  The fake
world refuses to start inside a process that already has a default
process group: run the dry-run in a process of its own.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .hloutil import CostRecorder, quiet_sharding_propagation, roofline_terms

_BACKEND = "repro_fake"


# --------------------------------------------------------------------------
# the fake world: a fake process group, a DeviceMesh, fake tensors
# --------------------------------------------------------------------------

def _create_fake_pg(store, rank, world_size, timeout):
    """A process group that issues no communication (each collective's
    result has its shape, not its values)."""
    from torch._C._distributed_c10d import FakeProcessGroup
    make = getattr(FakeProcessGroup, "_create_internal", None)
    return (make(rank, world_size) if make is not None
            else FakeProcessGroup(rank, world_size))


def _register_backend():
    import torch.distributed as dist
    if not hasattr(dist.Backend, _BACKEND.upper()):
        dist.Backend.register_backend(_BACKEND, _create_fake_pg,
                                      devices=["cpu", "cuda"])


class _HostPassthrough(TorchDispatchMode):
    """Ops whose tensors are all real (a KV cache's fill counters, kept on
    the host) run for real under the fake mode, so the step can read
    them as it does on a device.  A literal lifted into a tensor
    (``lift_fresh``) is left to the fake mode, which makes it a fake
    constant."""

    _LIFT = {torch.ops.aten.lift_fresh.default,
             torch.ops.aten.lift_fresh_copy.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.utils._pytree import tree_leaves
        kwargs = kwargs or {}
        ts = [t for t in tree_leaves((args, kwargs))
              if isinstance(t, torch.Tensor)]
        if (func not in self._LIFT and ts
                and all(type(t) is torch.Tensor for t in ts)):
            with unset_fake_temporarily():
                return func(*args, **kwargs)
        return func(*args, **kwargs)


@contextlib.contextmanager
def _fake_world(shape: Tuple[int, ...], axes: Tuple[str, ...],
                device_type: str):
    """A ``DeviceMesh`` of ``shape`` as rank 0 of a fake process group of
    its size, with fake tensors on ``device_type``.  Refuses to start
    when a default process group exists, and destroys its own on exit."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    if dist.is_available() and dist.is_initialized():
        raise RuntimeError(
            "the dry-run's fake world needs a process of its own: a default "
            "process group already exists (run `python -m "
            "repro_torch.launch.dryrun` in a subprocess)")
    _register_backend()
    dist.init_process_group(_BACKEND, store=dist.HashStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        mesh = init_device_mesh(device_type, tuple(shape),
                                mesh_dim_names=tuple(axes))
        with FakeTensorMode(), _HostPassthrough(), \
                quiet_sharding_propagation():
            yield mesh
    finally:
        dist.destroy_process_group()


def _local_shape(shape, placements, mesh) -> Tuple[int, ...]:
    """Rank 0's shard of a global ``shape`` (the largest shard)."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            out[p.dim] = -(-out[p.dim] // mesh.size(i))
    return tuple(out)


def _fake_tree(spec_tree, shardings, device, keep=()):
    """A fake ``DTensor`` for each meta leaf of ``spec_tree`` on its
    sharding; leaves named in ``keep`` (host counters) are real zeros."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor

    from ..tree import named_leaves, unflatten

    named, shs = named_leaves(spec_tree), named_leaves(shardings)

    def leaf(name, x, sh):
        if name.split("/")[-1] in keep:
            with unset_fake_temporarily():
                return torch.zeros(x.shape, dtype=x.dtype)
        pl = sh.placements
        local = torch.empty(_local_shape(x.shape, pl, sh.mesh),
                            dtype=x.dtype, device=device)
        return DTensor.from_local(local, sh.mesh, pl, run_check=False)

    return unflatten(spec_tree, [leaf(n, x, sh)
                                 for (n, x), (_, sh) in zip(named, shs)])


def _local_bytes(tree) -> int:
    """This rank's bytes of every tensor leaf (a ``DTensor``'s local
    shard)."""
    from ..dist.api import is_dtensor
    from ..tree import leaves
    total = 0
    for x in leaves(tree):
        if isinstance(x, torch.Tensor):
            t = x._local_tensor if is_dtensor(x) else x
            total += t.numel() * t.element_size()
    return total


# --------------------------------------------------------------------------
# lowering one cell
# --------------------------------------------------------------------------

def _lower(cfg, shape, mesh, device):
    """The cell's sharded step and its fake inputs: ``(fn, args)``, made
    inside ``_fake_world``."""
    from ..configs.shapes import batch_specs, cache_specs
    from ..launch.steps import (_HOST_LEAVES, default_optimizer,
                                jit_prefill_step, jit_serve_step,
                                jit_train_step, serve_shardings, state_specs)

    if shape.kind == "train":
        opt = default_optimizer(cfg)
        bsp = batch_specs(cfg, shape)
        fn, state_sh, bsh = jit_train_step(cfg, opt, mesh, bsp)
        return fn, (_fake_tree(state_specs(cfg, opt), state_sh, device),
                    _fake_tree(bsp, bsh, device))
    long_ctx = shape.kind == "decode" and shape.seq_len >= 2 ** 19
    ps, cs, bshard, _ = serve_shardings(cfg, mesh, shape.global_batch,
                                        shape.seq_len, long_context=long_ctx)
    from ..models import init_params
    params = _fake_tree(init_params(cfg, None, "meta"), ps, device)
    cache = _fake_tree(cache_specs(cfg, shape), cs, device, keep=_HOST_LEAVES)
    if shape.kind == "prefill":
        bsp = batch_specs(cfg, shape)
        fn, _, _ = jit_prefill_step(cfg, mesh, bsp, shape.global_batch,
                                    shape.seq_len)
        return fn, (params, _fake_tree(
            bsp, {k: bshard(v) for k, v in bsp.items()}, device), cache)
    fn, _, _ = jit_serve_step(cfg, mesh, shape.global_batch, shape.seq_len,
                              long_context=long_ctx)
    tok = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                      device="meta")
    return fn, (params, _fake_tree(tok, bshard(tok), device), cache)


def _cost_cfg(cfg, n_units: int):
    """Reduced-depth clone for the cost counts, as the reference's (whose
    ``scan_layers=False, unroll_scans=True`` make its HLO counts exact;
    the port's eager layers count the same either way).  The SSM chunk is
    raised as the reference raises it, so both count the same chunking."""
    kw = dict(scan_layers=False, unroll_scans=True,
              ssm_chunk=max(cfg.ssm_chunk, 2048))
    if cfg.block == "encdec":
        kw.update(enc_layers=n_units, dec_layers=n_units, n_layers=n_units)
    elif cfg.block == "mamba2_hybrid":
        kw.update(n_layers=n_units * cfg.hybrid_period)
    else:
        kw.update(n_layers=n_units)
    return cfg.replace(**kw)


def _extract(recorder: CostRecorder) -> Tuple[float, float, Dict[str, float]]:
    return (float(recorder.flops), float(recorder.bytes_accessed),
            recorder.collectives)


def _units(cfg) -> int:
    if cfg.block == "encdec":
        return cfg.dec_layers
    if cfg.block == "mamba2_hybrid":
        return cfg.n_layers // cfg.hybrid_period
    return cfg.n_layers


def count_cost(cfg, shape, mesh, device) -> CostRecorder:
    """One run of ``cfg``'s sharded step under a ``CostRecorder``."""
    fn, args = _lower(cfg, shape, mesh, device)
    rec = CostRecorder()
    with rec:
        fn(*args)
    return rec


def extrapolated_cost(cfg, shape, mesh, device) -> Dict:
    """Count the depth-1 and depth-2 clones; extrapolate to full depth."""
    f1, b1, k1 = _extract(count_cost(_cost_cfg(cfg, 1), shape, mesh, device))
    f2, b2, k2 = _extract(count_cost(_cost_cfg(cfg, 2), shape, mesh, device))
    n = _units(cfg)

    def ext(v1, v2):
        return v1 + (n - 1) * (v2 - v1)

    coll = {key: ext(k1.get(key, 0.0), k2.get(key, 0.0))
            for key in set(k1) | set(k2)}
    return {"flops": ext(f1, f2), "hbm_bytes": ext(b1, b2),
            "collectives": coll,
            "depth_points": {"1": {"flops": f1, "bytes": b1},
                             "2": {"flops": f2, "bytes": b2}},
            "units_extrapolated_to": n}


def _summary(snapshot: Dict) -> str:
    """MemTracker's peak snapshot as one line a device."""
    parts = []
    for dev, kinds in snapshot.items():
        body = ", ".join(f"{getattr(k, 'value', k)} {v}"
                         for k, v in kinds.items())
        parts.append(f"peak on {dev}: {body}")
    return "MemTracker " + "; ".join(parts)


def proof(cfg, shape, mesh, device) -> Dict:
    """The production step once under ``MemTracker``: the memory record
    and MemTracker's summary."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from ..tree import leaves

    fn, args = _lower(cfg, shape, mesh, device)
    arg_bytes = _local_bytes(args)
    mt = MemTracker()
    mt.track_external(*(x for x in leaves(args)
                        if isinstance(x, torch.Tensor)))
    with mt:
        out = fn(*args)
    peak_snap = mt.get_tracker_snapshot("peak")
    peak = sum(kinds["Total"] for kinds in peak_snap.values())
    mem = {"argument_bytes": arg_bytes, "output_bytes": _local_bytes(out),
           "temp_bytes": max(0, peak - arg_bytes)}
    mem["peak_bytes"] = mem["argument_bytes"] + mem["temp_bytes"]
    return {"memory": mem, "memory_analysis_str": _summary(peak_snap)}


# --------------------------------------------------------------------------
# one cell
# --------------------------------------------------------------------------

def _mesh_of(multi_pod: bool, mesh_shape):
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    if mesh_shape:
        return tuple(mesh_shape), ("data", "model")
    return (16, 16), ("data", "model")


def run_cell(arch: str, shape_name, multi_pod: bool,
             verbose: bool = True, skip_cost: bool = False,
             overrides: Optional[Dict] = None,
             mesh_shape: Optional[Tuple[int, int]] = None,
             tag: str = "", device=None) -> Dict:
    """One dry-run cell.  `overrides` (ModelConfig.replace kwargs) and
    `mesh_shape` (dp, tp) are the §Perf hillclimbing knobs — they let an
    experiment re-run the same cell under a different mapping.
    ``shape_name`` names an entry of ``SHAPES`` or is a ``ShapeCfg``;
    ``device`` is the fake tensors' device (``None``: the card)."""
    from ..configs import SHAPES, applicable, get_config, \
        model_flops_per_step
    from ..device import resolve_device

    dev = resolve_device(device)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mesh_dims, axes = _mesh_of(multi_pod, mesh_shape)
    mesh_name = "x".join(str(n) for n in mesh_dims)
    rec: Dict = {"arch": arch, "shape": shape.name, "mesh": mesh_name}
    if tag:
        rec["tag"] = tag
    if overrides:
        rec["overrides"] = {k: str(v) for k, v in overrides.items()}
    try:
        cfg = get_config(arch)
        if overrides:
            cfg = cfg.replace(**overrides)
    except Exception as e:  # noqa: BLE001 — report failures as data
        return _failed(rec, e, verbose)
    ok, why = applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        if verbose:
            print(f"[{arch} x {shape.name}] SKIP: {why}")
        return rec

    n_chips = math.prod(mesh_dims)
    with _fake_world(mesh_dims, axes, dev.type) as mesh:
        t0 = time.time()
        try:
            # ---- PROOF: the production config's step runs; its memory ----
            p = proof(cfg, shape, mesh, dev)
            t_proof = time.time() - t0
            mem = p["memory"]
            rec.update(status="ok", chips=n_chips,
                       compile_s=round(t_proof, 1), memory=mem,
                       memory_analysis_str=p["memory_analysis_str"])

            # ---- COST: depth-1/2 clones, extrapolated ---------------------
            if not multi_pod and not skip_cost:
                t1 = time.time()
                cost = extrapolated_cost(cfg, shape, mesh, dev)
                rec["cost_compile_s"] = round(time.time() - t1, 1)
                terms = roofline_terms(cost["flops"], cost["hbm_bytes"],
                                       cost["collectives"].get("total", 0.0))
                mflops = model_flops_per_step(cfg, shape) / n_chips
                rec.update(per_device=cost, roofline=terms,
                           model_flops_per_device=mflops,
                           useful_compute_fraction=(
                               mflops / cost["flops"] if cost["flops"]
                               else 0.0))
            if verbose:
                msg = (f"[{arch} x {shape.name} @ {rec['mesh']}] "
                       f"proof {t_proof:.0f}s  "
                       f"args={mem['argument_bytes']/1e9:.2f}GB "
                       f"temp={(mem['temp_bytes'] or 0)/1e9:.2f}GB")
                if "roofline" in rec:
                    t = rec["roofline"]
                    msg += (f"  | compute {t['compute_s']*1e3:.2f}ms "
                            f"memory {t['memory_s']*1e3:.2f}ms "
                            f"collective {t['collective_s']*1e3:.2f}ms "
                            f"dominant={t['dominant']} "
                            f"useful={rec['useful_compute_fraction']:.2f}")
                print(msg)
        except Exception as e:  # noqa: BLE001 — report failures as data
            _failed(rec, e, verbose)
    return rec


def _failed(rec: Dict, e: Exception, verbose: bool) -> Dict:
    rec.update(status="error", error=f"{type(e).__name__}: {e}",
               traceback=traceback.format_exc()[-2000:])
    if verbose:
        print(f"[{rec['arch']} x {rec['shape']} @ {rec['mesh']}] "
              f"FAILED: {e}")
    return rec


def parse_overrides(items) -> Dict:
    """``key=value`` strings as ModelConfig overrides: true/false, ints,
    floats, else strings."""
    overrides = {}
    for ov in items:
        k, v = ov.split("=", 1)
        if v in ("true", "false"):
            overrides[k] = v == "true"
        else:
            try:
                overrides[k] = int(v)
            except ValueError:
                try:
                    overrides[k] = float(v)
                except ValueError:
                    overrides[k] = v
    return overrides


def main(argv=None):
    from ..configs import ASSIGNED, SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-cost", action="store_true",
                    help="proof run only (no depth-1/2 cost counts)")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--override", action="append", default=[],
                    help="hillclimb knob: key=value ModelConfig override")
    ap.add_argument("--mesh-shape", default=None,
                    help="hillclimb knob: dpxtp, e.g. 1x256")
    ap.add_argument("--tag", default="", help="label for this variant")
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device type (default: the card)")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.override)
    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split("x"))
                  if args.mesh_shape else None)

    cells = ([(a, s) for a in ASSIGNED for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    records = []
    for arch, shape in cells:
        rec = run_cell(arch, shape, args.multipod, skip_cost=args.skip_cost,
                       overrides=overrides or None, mesh_shape=mesh_shape,
                       tag=args.tag, device=args.device)
        records.append(rec)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"dry-run: {n_ok} ok, {n_skip} skipped, {n_err} failed")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
