"""The port's configs, ModelConfig, input specs and tops_bridge against the
JAX package's: every CONFIG and SMOKE_CONFIG field by field, the derived
sizes and parameter counts, the shapes module (meta tensors in place of
ShapeDtypeStructs) and the TOPS pod-level DSE on
tests/test_hloutil_bridge.py's cases."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.configs import shapes as j_shapes  # noqa: E402
from repro.core import tops_bridge as j_tops  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs import shapes as t_shapes  # noqa: E402
from repro_torch.core import tops_bridge as t_tops  # noqa: E402
from repro_torch.models import ModelConfig  # noqa: E402

ARCHS = sorted(j_configs.ARCHS)
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
          jnp.float16: torch.float16, jnp.int32: torch.int32}


# the port's own fields, at the end of its ModelConfig: Falcon-Mamba's
# mixer norms, which the JAX package's configs lack (set only by
# falcon-mamba-7b)
PORT_ONLY = {"mixer_rms_eps": {"falcon-mamba-7b": 1e-6}}


def test_same_registry():
    assert list(t_configs.ARCHS) == list(j_configs.ARCHS)
    assert t_configs.ASSIGNED == j_configs.ASSIGNED
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(j_configs.get_config("gemma-2b"))] \
        + list(PORT_ONLY)


@pytest.mark.parametrize("smoke", [False, True], ids=["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_by_field(arch, smoke):
    j_cfg = j_configs.get_config(arch, smoke=smoke)
    t_cfg = t_configs.get_config(arch.replace("-", "_"), smoke=smoke)
    for field, values in PORT_ONLY.items():
        assert getattr(t_cfg, field) == values.get(arch), field
    t_cfg = t_cfg.replace(**{field: None for field in PORT_ONLY})
    assert dataclasses.asdict(t_cfg) == {
        **dataclasses.asdict(j_cfg), **{field: None for field in PORT_ONLY}}
    for prop in ("vocab_padded", "hd", "d_inner", "dtr", "n_ssm_heads",
                 "is_attention_free", "supports_long_context",
                 "n_hybrid_invocations"):
        assert getattr(t_cfg, prop) == getattr(j_cfg, prop), prop
    assert t_cfg.torch_dtype == DTYPES[j_cfg.jdtype]
    assert t_cfg.param_count() == j_cfg.param_count()
    assert t_cfg.active_param_count() == j_cfg.active_param_count()


def test_param_counts_match_published():
    """tests/test_models.py::test_param_counts_match_published on the
    port's configs."""
    expected = {
        "falcon-mamba-7b": 7.27e9, "internvl2-1b": 0.49e9,
        "zamba2-2.7b": 2.4e9, "chatglm3-6b": 6.2e9, "gemma-2b": 2.5e9,
        "minitron-4b": 4.2e9, "stablelm-3b": 2.8e9, "olmoe-1b-7b": 6.9e9,
        "kimi-k2-1t-a32b": 1.04e12, "whisper-base": 0.1e9,
    }
    for arch, n in expected.items():
        got = t_configs.get_config(arch).param_count()
        assert abs(got - n) / n < 0.12, (arch, got, n)
    assert t_configs.get_config("olmoe-1b-7b").active_param_count() < 1.5e9
    assert t_configs.get_config(
        "kimi-k2-1t-a32b").active_param_count() < 35e9


@pytest.mark.parametrize("shape", sorted(j_shapes.SHAPES))
def test_shapes_applicability_and_model_flops(shape):
    assert dataclasses.asdict(t_shapes.SHAPES[shape]) == \
        dataclasses.asdict(j_shapes.SHAPES[shape])
    for arch in ARCHS:
        j_cfg, t_cfg = j_configs.get_config(arch), t_configs.get_config(arch)
        assert t_shapes.applicable(t_cfg, t_shapes.SHAPES[shape]) == \
            j_shapes.applicable(j_cfg, j_shapes.SHAPES[shape])
        assert t_shapes.model_flops_per_step(t_cfg, t_shapes.SHAPES[shape]) \
            == j_shapes.model_flops_per_step(j_cfg, j_shapes.SHAPES[shape])


def _spec_leaves(tree):
    """(shape, dtype name) of every leaf, in jax.tree.leaves' order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _spec_leaves(v)]
    return [(tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch, shape):
    """Batch and cache specs at smoke scale 64 on the full configs: the
    port's meta tensors have the reference's shapes and dtypes (its fill
    counters are int32 host tensors)."""
    j_cfg, t_cfg = j_configs.get_config(arch), t_configs.get_config(arch)
    j_spec = j_shapes.input_specs(j_cfg, shape, smoke_scale=64)
    t_spec = t_shapes.input_specs(t_cfg, shape, smoke_scale=64)
    assert sorted(t_spec) == sorted(j_spec)
    assert _spec_leaves(t_spec) == [(tuple(x.shape), str(x.dtype))
                                    for x in jax.tree.leaves(j_spec)]
    for leaf in jax.tree.leaves(t_spec, is_leaf=torch.is_tensor):
        assert leaf.device.type in ("meta", "cpu")


# tests/test_hloutil_bridge.py's cases: (arch, shape, n_chips)
TOPS_CASES = [("gemma-2b", "train_4k", 256), ("kimi-k2-1t-a32b",
                                                "train_4k", 512)]


def _ranked(mod, cfg, shape, n_chips, flexible):
    return [(dataclasses.asdict(m), dataclasses.asdict(c))
            for m, c in mod.autoshard(cfg, shape, n_chips, flexible)]


@pytest.mark.parametrize("flexible", [True, False])
@pytest.mark.parametrize("arch,shape,n_chips", TOPS_CASES)
def test_tops_autoshard_equals_reference(arch, shape, n_chips, flexible):
    got = _ranked(t_tops, t_configs.get_config(arch),
                  t_shapes.SHAPES[shape], n_chips, flexible)
    want = _ranked(j_tops, j_configs.get_config(arch),
                   j_shapes.SHAPES[shape], n_chips, flexible)
    assert got == want


@pytest.mark.parametrize("mapping", [(512, 1, False, False, 1, True),
                                     (16, 16, True, True, 4, False),
                                     (1, 256, False, True, 8, True)])
def test_tops_cost_mapping_equals_reference(mapping):
    for arch in ("gemma-2b", "olmoe-1b-7b", "falcon-mamba-7b"):
        got = t_tops.cost_mapping(t_configs.get_config(arch),
                                  t_shapes.SHAPES["train_4k"],
                                  t_tops.PodMapping(*mapping), 256)
        want = j_tops.cost_mapping(j_configs.get_config(arch),
                                   j_shapes.SHAPES["train_4k"],
                                   j_tops.PodMapping(*mapping), 256)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.bound_s, got.dominant) == (want.bound_s, want.dominant)


def test_tops_bridge_autoshard():
    """tests/test_hloutil_bridge.py::test_tops_bridge_autoshard on the
    port."""
    cfg = t_configs.get_config("gemma-2b")
    shape = t_shapes.SHAPES["train_4k"]
    ranked = t_tops.autoshard(cfg, shape, n_chips=256, flexible=True)
    best_m, best_c = ranked[0]
    assert best_c.fits
    default = t_tops.autoshard(cfg, shape, 256, flexible=False)[0]
    assert default[1].bound_s >= best_c.bound_s * 0.999
    bad = t_tops.cost_mapping(cfg, shape,
                              t_tops.PodMapping(512, 1, False, False, 1, True),
                              256)
    assert not bad.fits


def test_tops_bridge_kimi_needs_sharded_state():
    """tests/test_hloutil_bridge.py::test_tops_bridge_kimi_needs_sharded_state
    on the port."""
    cfg = t_configs.get_config("kimi-k2-1t-a32b")
    best_m, best_c = t_tops.autoshard(cfg, t_shapes.SHAPES["train_4k"],
                                      n_chips=512)[0]
    assert best_c.fits
    assert best_m.fsdp or best_m.tp >= 256


def test_tops_report_prints_like_reference():
    got, want = [], []
    t_tops.autoshard_report("gemma-2b", "train_4k", print_fn=got.append)
    j_tops.autoshard_report("gemma-2b", "train_4k", print_fn=want.append)
    assert got == want
    assert np.isclose(t_tops.PEAK_FLOPS, j_tops.PEAK_FLOPS)
