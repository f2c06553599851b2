"""The port's distribution tables against the reference's, exactly, and the
reference's own checks of its logical-axis API that are not about jax.

* Every table of ``dist/sharding.py`` and ``opt_shardings`` (``make_rules``
  with every knob, ``batch_spec``, ``param_shardings``, ``cache_shardings``,
  ``opt_shardings`` for AdamW, SGD and Adafactor, factored and not) for
  every architecture at its smoke config, leaf for leaf, on the meshes
  (1,), (1,1), (2,2), (16,16) and (2,16,16).  The port's meshes are
  ``DeviceMesh``es over a fake process group, in a subprocess
  (``tests/_torch_dist_specs.py``); the reference's are
  ``jax.sharding.AbstractMesh``es (specs only, no devices).
* ``logical_to_spec``, ``validate_spec`` (unknown axes, reuse, rank,
  divisibility), ``axis_rules`` nesting and ``constrain``'s no-op outside
  a binding, as ``tests/test_dist_api.py`` and ``tests/test_distribution.py``
  check them on the reference, on a shape-only mesh (an object with
  ``mesh_dim_names`` and ``shape``, which is all these functions read).
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_dist_specs import MESHES, mesh_key, tables  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.dist import (DEFAULT_RULES, P, axis_rules,  # noqa: E402
                              batch_spec, cache_shardings, constrain,
                              current_rules, logical_to_spec, make_rules,
                              param_shardings, validate_spec)
from repro_torch.models import init_cache, init_params  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def shape_mesh(shape, names):
    """A mesh as the spec functions read it: axis names and sizes."""
    return SimpleNamespace(mesh_dim_names=tuple(names), shape=tuple(shape))


@pytest.fixture(scope="module")
def port_tables():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable,
                          str(REPO / "tests" / "_torch_dist_specs.py")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def reference_tables(shape, names) -> dict:
    from repro import models as J
    from repro.configs import ARCHS as J_ARCHS, get_config
    from repro.dist.sharding import (batch_spec as j_batch_spec,
                                     cache_shardings as j_cache_shardings,
                                     make_rules as j_make_rules,
                                     param_shardings as j_param_shardings)
    from repro.optim import adafactor, adamw, opt_shardings, sgd
    from repro_torch.tree import named_leaves

    ns = SimpleNamespace(
        make_rules=j_make_rules, batch_spec=j_batch_spec,
        param_shardings=j_param_shardings,
        cache_shardings=j_cache_shardings, opt_shardings=opt_shardings,
        adamw=adamw, sgd=sgd, adafactor=adafactor, ARCHS=J_ARCHS,
        get_config=get_config, named_leaves=named_leaves,
        shape_of=lambda s: jax.ShapeDtypeStruct(s, jnp.int32))
    mesh = jax.sharding.AbstractMesh(tuple(shape), tuple(names))
    return tables(
        ns, mesh,
        lambda cfg: jax.eval_shape(
            lambda: J.init_params(cfg, jax.random.PRNGKey(0))),
        lambda cfg, b, s: jax.eval_shape(lambda: J.init_cache(cfg, b, s)))


@pytest.mark.parametrize("shape,names", MESHES,
                         ids=[mesh_key(s) for s, _ in MESHES])
def test_tables_equal_the_reference(port_tables, shape, names):
    want = json.loads(json.dumps(reference_tables(shape, names)))
    got = port_tables[mesh_key(shape)]
    assert got["rules"] == want["rules"]
    assert got["batch"] == want["batch"]
    assert sorted(got["arch"]) == sorted(want["arch"]) == sorted(ARCHS)
    for arch in sorted(ARCHS):
        for table, leaves in want["arch"][arch].items():
            assert got["arch"][arch][table] == leaves, (arch, table)


def test_tables_shard_on_the_large_meshes(port_tables):
    """A control on the comparison: at (2,16,16) the tables really shard
    (the pod axis composes with data), so equal tables are not equal
    replication."""
    t = port_tables["2x16x16"]["arch"]["gemma-2b"]
    assert t["params fsdp=True"]["embed"] == ["model", ["pod", "data"]]
    assert t["cache long_context=True"]["k"] == [
        None, ["pod", "data"], "model", None, None]
    factored = t["opt adafactor factored fsdp=True"]
    assert factored["stack/layers/mlp/w_gate/vr"] == [None, ["pod", "data"]]
    assert factored["stack/layers/mlp/w_gate/vc"] == [None, "model"]


# ---- the reference's own checks (tests/test_dist_api.py,
# tests/test_distribution.py), on the port -----------------------------

def test_logical_to_spec_resolution():
    rules = dict(DEFAULT_RULES)
    assert logical_to_spec(("batch", "seq", "ff"), rules) \
        == P(("pod", "data"), None, "model")
    assert logical_to_spec(("no_such_axis", "vocab"), rules) \
        == P(None, "model")
    assert logical_to_spec((None, None), rules) == P(None, None)
    # a one-name tuple is the name, as in the reference; trailing Nones
    # count
    assert P(("data",)) == P("data") and P(None) != P()


def test_validate_spec_unknown_duplicate_and_rank():
    mesh = shape_mesh((1,), ("data",))
    assert validate_spec(P("model"), (8,), mesh) == P(None)
    assert validate_spec(P(("data", "model")), (8,), mesh) == P(("data",))
    assert validate_spec(P("data", "data"), (4, 4), mesh) == P("data", None)
    assert validate_spec(P(("data",), ("data",)), (4, 4), mesh) \
        == P(("data",), None)
    assert validate_spec(P("data", None, None), (4,), mesh) == P("data")
    assert validate_spec(P("data"), (7,), mesh) == P("data")  # size 1


def test_validate_spec_divisibility():
    mesh = shape_mesh((4,), ("model",))
    assert validate_spec(P("model"), (7,), mesh) == P(None)
    assert validate_spec(P("model"), (8,), mesh) == P("model")
    mesh2 = shape_mesh((2, 2), ("pod", "data"))
    assert validate_spec(P(("pod", "data")), (2,), mesh2) == P(("pod",))
    assert validate_spec(P(("pod", "data")), (4,), mesh2) \
        == P(("pod", "data"))


def test_constrain_noop_outside_context():
    assert current_rules() is None
    x = torch.ones((4, 8))
    assert constrain(x, ("batch", "seq")) is x


def test_axis_rules_binds_and_nests():
    mesh = shape_mesh((1,), ("data",))
    outer = make_rules(mesh)
    inner = dict(outer, batch=None)
    with axis_rules(mesh, outer):
        got_mesh, got_rules = current_rules()
        assert got_mesh is mesh and got_rules["batch"] == ("data",)
        with axis_rules(mesh, inner):
            assert current_rules()[1]["batch"] is None
        assert current_rules()[1]["batch"] == ("data",)
        # a plain tensor passes through a binding untouched
        x = torch.ones((4, 8))
        assert constrain(x, ("batch", None)) is x
    assert current_rules() is None


def test_make_rules_filters_to_mesh_and_knobs():
    mesh = shape_mesh((1,), ("data",))
    r = make_rules(mesh)
    assert r["heads"] is None and r["batch"] == ("data",)
    assert r["act_seq"] is None and r["kv_seq"] is None and r["embed"] is None
    r = make_rules(mesh, fsdp=True, seq_activations=True, long_context=True)
    assert r["embed"] == ("data",)
    assert r["act_seq"] is None and r["kv_seq"] is None
    r2 = make_rules(shape_mesh((1, 1), ("data", "model")),
                    seq_activations=True, long_context=True)
    assert r2["act_seq"] == "model" and r2["kv_seq"] == "model"


def test_batch_spec_shards_leading_dim():
    mesh = shape_mesh((1,), ("data",))
    shard = batch_spec(mesh, make_rules(mesh))
    assert shard(torch.empty((4, 16), device="meta")).spec \
        == P(("data",), None)
    assert shard(torch.empty((), device="meta")).spec == P()


def test_param_and_cache_shardings_bind_expected_axes():
    from repro_torch.configs import get_config
    mesh = shape_mesh((1, 1), ("data", "model"))
    rules = make_rules(mesh, fsdp=True)
    cfg = get_config("gemma-2b", smoke=True)
    ps = param_shardings(cfg, init_params(cfg, None, "meta"), mesh, rules)
    assert ps["embed"].spec == P("model", ("data",))
    assert ps["stack"]["layers"]["mlp"]["w_gate"].spec \
        == P(None, ("data",), "model")
    assert ps["stack"]["layers"]["attn"]["wo"].spec \
        == P(None, "model", ("data",))
    assert ps["ln_f"].spec == P()
    cs = cache_shardings(cfg, init_cache(cfg, 2, 32, "meta"), mesh, rules)
    assert cs.k.spec == P(None, ("data",), None, "model", None)
    assert cs.pos.spec == P(None)
    moe_cfg = get_config("olmoe-1b-7b", smoke=True)
    mps = param_shardings(moe_cfg, init_params(moe_cfg, None, "meta"), mesh,
                          rules)
    assert mps["stack"]["layers"]["moe"]["w_down"].spec \
        == P(None, "model", None, ("data",))


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist import NamedSharding
    mesh = shape_mesh((2, 16, 16), ("pod", "data", "model"))
    sh = NamedSharding(mesh, P("model", ("pod", "data")))
    assert sh.placements == [Shard(1), Shard(1), Shard(0)]
    assert NamedSharding(mesh, P()).placements == [Replicate()] * 3
    # DTensor shards one dim over several mesh dims major first only
    with pytest.raises(ValueError, match="mesh order"):
        NamedSharding(mesh, P(("data", "pod"))).placements


def test_the_package_never_uses_the_fake_process_group():
    """torch's fake process group (``torch.testing._internal``) builds the
    tests' large meshes; the package itself never reaches for it."""
    sources = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    assert sources
    for path in sources:
        assert "torch.testing" not in path.read_text(), path
