"""The sharding tables of either package, as plain data for a comparison:
every factory of ``dist/sharding.py`` and ``opt_shardings`` over every
architecture at its smoke config, on one mesh.

``tables(ns, mesh, meta_params, meta_cache)`` reads the factories from
``ns`` (the reference's or the port's modules: the two share names), so
one function builds both sides.  Specs become lists of entries (``None``,
an axis name, or a list of names), keyed by the leaf's path.

Run as a script it prints the port's tables as JSON, each mesh built as a
``DeviceMesh`` over a fake process group of the mesh's size (no devices,
no ranks):

    PYTHONPATH=src python tests/_torch_dist_specs.py
"""
import json
import sys
from pathlib import Path
from types import SimpleNamespace

REPO = Path(__file__).resolve().parents[1]
if str(REPO / "src") not in sys.path:
    sys.path.insert(0, str(REPO / "src"))

# (shape, axis names) of every mesh the tables are compared on
MESHES = [((1,), ("data",)), ((1, 1), ("data", "model")),
          ((2, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
KNOBS = [dict(fsdp=f, seq_activations=s, long_context=c)
         for f in (False, True) for s in (False, True) for c in (False, True)]
# batch_spec's inputs: scalars, a batch that every data axis divides, one
# that only some do, and odd ones
BATCH_SHAPES = [(), (4,), (64, 16), (2, 16), (3, 5), (32, 1, 7), (1, 1)]
# the cache's batch: 64 is divided by every data-axis product up to 32
CACHE_BATCH, CACHE_LEN = 64, 32


def mesh_key(shape) -> str:
    return "x".join(str(n) for n in shape)


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def _spec(sharding) -> list:
    return [_entry(e) for e in tuple(sharding.spec)]


def _specs(named_leaves, tree) -> dict:
    return {path: _spec(sh) for path, sh in named_leaves(tree)}


def tables(ns, mesh, meta_params, meta_cache) -> dict:
    """Every table on ``mesh``.  ``ns`` carries ``make_rules``,
    ``batch_spec``, ``param_shardings``, ``cache_shardings``,
    ``opt_shardings``, ``adamw``, ``sgd``, ``adafactor``, ``ARCHS``,
    ``get_config``, ``named_leaves`` and ``shape_of`` (a shape as a
    ``batch_spec`` input); ``meta_params(cfg)`` / ``meta_cache(cfg, b,
    s)`` give shape-only trees."""
    out = {"rules": {}, "batch": {}, "arch": {}}
    for knobs in KNOBS:
        rules = ns.make_rules(mesh, **knobs)
        key = ",".join(k for k, v in knobs.items() if v) or "none"
        out["rules"][key] = {k: _entry(v) for k, v in sorted(rules.items())}
    for fsdp in (False, True):
        shard = ns.batch_spec(mesh, ns.make_rules(mesh, fsdp=fsdp))
        out["batch"][f"fsdp={fsdp}"] = [_spec(shard(ns.shape_of(s)))
                                        for s in BATCH_SHAPES]
    out["batch"]["default"] = [_spec(ns.batch_spec(mesh)(ns.shape_of(s)))
                               for s in BATCH_SHAPES]
    for arch in sorted(ns.ARCHS):
        cfg = ns.get_config(arch, smoke=True)
        p_spec = meta_params(cfg)
        t = {}
        for fsdp in (False, True):
            rules = ns.make_rules(mesh, fsdp=fsdp)
            ps = ns.param_shardings(cfg, p_spec, mesh, rules)
            t[f"params fsdp={fsdp}"] = _specs(ns.named_leaves, ps)
            for name, opt in (("adamw", ns.adamw(3e-4)), ("sgd", ns.sgd()),
                              ("adafactor", ns.adafactor(1e-2)),
                              ("adafactor factored",
                               ns.adafactor(1e-2, min_dim_factored=4))):
                t[f"opt {name} fsdp={fsdp}"] = _specs(
                    ns.named_leaves, ns.opt_shardings(opt, ps, p_spec, mesh))
        t["params default"] = _specs(ns.named_leaves,
                                     ns.param_shardings(cfg, p_spec, mesh))
        c_spec = meta_cache(cfg, CACHE_BATCH, CACHE_LEN)
        for lc in (False, True):
            rules = ns.make_rules(mesh, long_context=lc)
            t[f"cache long_context={lc}"] = _specs(
                ns.named_leaves, ns.cache_shardings(cfg, c_spec, mesh, rules))
        out["arch"][arch] = t
    return out


def port_namespace():
    import torch

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.dist.sharding import (batch_spec, cache_shardings,
                                           make_rules, param_shardings)
    from repro_torch.optim import adafactor, adamw, opt_shardings, sgd
    from repro_torch.tree import named_leaves
    return SimpleNamespace(
        make_rules=make_rules, batch_spec=batch_spec,
        param_shardings=param_shardings, cache_shardings=cache_shardings,
        opt_shardings=opt_shardings, adamw=adamw, sgd=sgd,
        adafactor=adafactor, ARCHS=ARCHS, get_config=get_config,
        named_leaves=named_leaves,
        shape_of=lambda s: torch.empty(s, device="meta"))


def port_tables() -> dict:
    """The port's tables on every mesh, each a DeviceMesh over a fake
    process group of its size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.models import init_cache, init_params

    ns = port_namespace()
    out = {}
    for shape, names in MESHES:
        n = 1
        for s in shape:
            n *= s
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        try:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            out[mesh_key(shape)] = tables(
                ns, mesh, lambda cfg: init_params(cfg, None, "meta"),
                lambda cfg, b, s: init_cache(cfg, b, s, "meta"))
        finally:
            dist.destroy_process_group()
    return out


if __name__ == "__main__":
    print(json.dumps(port_tables()))
