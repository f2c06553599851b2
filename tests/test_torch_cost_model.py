"""The port's cost model against ``repro.core.cost_model`` on fixed genomes
over every MODEL_ZOO layer, with R pinned and R open: every CostResult
field within rel 1e-6 and ``feasible`` equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import cost_model as j_cm  # noqa: E402
from repro.core import mapspace as j_ms  # noqa: E402
from repro.core import spec as j_spec  # noqa: E402
from repro.core import workloads as j_wl  # noqa: E402
from repro.core.mapper import raw_tile_feasibility as j_raw  # noqa: E402

from repro_torch.core import convert  # noqa: E402
from repro_torch.core import cost_model as t_cm  # noqa: E402
from repro_torch.core.mapper import raw_tile_feasibility as t_raw  # noqa

RTOL = 1e-6
N_GENOMES = 24
# R pinned (the paper's 4-char classes) and R open (5th axis), full and
# part levels so hard-partitioned buffers are covered
SPECS = {
    "pinned": [j_spec.make_variant("1111", j_spec.PARTFLEX),
               j_spec.inflex_baseline()],
    "open": [j_spec.make_variant("11111")],
}


def _assert_close(j_res, t_res, what):
    for f in j_cm.CostResult._fields:
        a = np.asarray(getattr(j_res, f))
        b = getattr(t_res, f).cpu().numpy()
        if f == "feasible":
            assert np.array_equal(a, b), f"{what}: feasible"
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=0,
                                       err_msg=f"{what}: {f}")


@pytest.mark.parametrize("r_mode", sorted(SPECS))
@pytest.mark.parametrize("model", sorted(j_wl.MODEL_ZOO))
def test_population_matches_reference(model, r_mode):
    rng = np.random.default_rng(len(model))
    for js in SPECS[r_mode]:
        ts = convert.spec_from_dict(dataclasses.asdict(js))
        for layer in j_wl.get_model(model):
            space = j_ms.mapspace_for(layer, js)
            g = space.clip(space.sample(rng, N_GENOMES))
            tiles, orders, pairs, shapes, reprs = space.decode_batch(g)
            r_open = r_mode == "open"
            j_res = j_cm.evaluate_population(
                jnp.asarray(layer.dims), jnp.asarray(layer.stride),
                jnp.asarray(layer.depthwise), jnp.asarray(tiles),
                jnp.asarray(orders), jnp.asarray(pairs),
                jnp.asarray(shapes), js.hw, space.hard_partition,
                jnp.asarray(reprs) if r_open else None)
            T = torch.as_tensor
            t_res = t_cm.evaluate_population(
                T(np.asarray(layer.dims)), T(layer.stride),
                T(layer.depthwise), T(tiles), T(orders), T(pairs),
                T(shapes), ts.hw, space.hard_partition,
                T(reprs) if r_open else None)
            _assert_close(j_res, t_res, f"{model}/{layer.name}/{js.name}")


def test_rows_and_single_mapping_match_reference():
    """``evaluate_rows`` (one mapping per (layer, spec) row, per-row
    hard-partition flags) and ``evaluate_mapping`` against the reference."""
    js = j_spec.make_variant("11111", j_spec.PARTFLEX)
    ts = convert.spec_from_dict(dataclasses.asdict(js))
    layers = j_wl.get_model("mobilenetv2")[:12]
    rng = np.random.default_rng(4)
    rows = []
    for layer in layers:
        space = j_ms.mapspace_for(layer, js)
        g = space.clip(space.sample(rng, 1))
        t, o, p, s, r = space.decode_batch(g)
        rows.append((layer.dims, layer.stride, layer.depthwise, t[0], o[0],
                     p[0], s[0], bool(len(rows) % 2), r[0]))
    cols = [np.asarray(c) for c in zip(*rows)]
    j_res = j_cm.evaluate_rows(*(jnp.asarray(c) for c in cols[:8]), js.hw,
                               jnp.asarray(cols[8]))
    t_res = t_cm.evaluate_rows(*(torch.as_tensor(c) for c in cols[:8]),
                               ts.hw, torch.as_tensor(cols[8]))
    _assert_close(j_res, t_res, "rows")
    for i in range(len(layers)):
        j_one = j_cm.evaluate_mapping(*(jnp.asarray(c[i]) for c in cols[:7]),
                                      js.hw, cols[7][i],
                                      jnp.asarray(cols[8][i]))
        t_one = t_cm.evaluate_mapping(
            *(torch.as_tensor(c[i]) for c in cols[:7]), ts.hw,
            bool(cols[7][i]), torch.as_tensor(cols[8][i]))
        _assert_close(j_one, t_one, f"single {i}")


def test_prod6_is_xlas_reduction_order():
    """Past 2**24 a float32 product depends on its order; the port's
    explicit chain must be the order XLA's CPU reduction takes."""
    v = np.random.default_rng(0).integers(1000, 5000, (4096, 6)) \
        .astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.prod(a, axis=-1))(v))
    got = t_cm._prod6(torch.as_tensor(v)).numpy()
    assert np.array_equal(got, want)
    # the order matters on these inputs: a pairwise tree disagrees
    tree = (v[:, 0] * v[:, 1]) * (v[:, 2] * v[:, 3]) * (v[:, 4] * v[:, 5])
    assert not np.array_equal(tree, want)


def test_lower_bound_cycles_matches_reference():
    hw = j_spec.HWConfig()
    t_hw = convert.hw_from_dict(dataclasses.asdict(hw))
    for layer in j_wl.get_model("mnasnet"):
        assert t_cm.lower_bound_cycles(np.asarray(layer.dims),
                                       layer.depthwise, t_hw) == \
            j_cm.lower_bound_cycles(np.asarray(layer.dims), layer.depthwise,
                                    hw)


def test_raw_tile_feasibility_matches_reference():
    tiles = np.random.default_rng(9).integers(1, 120, (500, 6))
    buf = float(j_spec.HWConfig().buffer_elems)
    assert np.array_equal(
        t_raw(torch.as_tensor(tiles), buf).numpy(),
        np.asarray(j_raw(jnp.asarray(tiles), buf)))
