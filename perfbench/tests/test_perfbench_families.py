"""The decoder family (``perfbench/families/decoder.py``) against the
numbers the harness gave before families existed, pinned in
``decoder_pins.json``: the same leaves in the same order, the same
draws, and FLOP and byte counts equal to the integer.  Also: every
family file provides what the harness asks of a family."""
import json
import pathlib

import pytest
import torch

from perfbench import bench, flops, weights
from perfbench.tests.conftest import PB_CONFIGS, REPO, tiny_conf

PINS = json.loads(pathlib.Path(__file__).with_name("decoder_pins.json")
                  .read_text())
CONFIGS = sorted(PINS["configs"])
FAMILIES = sorted(p.stem for p in (REPO / "perfbench" / "families")
                  .glob("*.py"))
INTERFACE = ("BLOCKS", "FIELDS", "check", "leaves", "train_step_flops",
             "serve_request_flops", "attention_flops", "reference")


def conf_of(name):
    return json.loads(PB_CONFIGS[name].read_text())


def table(conf, qk_gain=1.0):
    return [[leaf.path, list(leaf.shape), str(leaf.dtype).split(".")[-1],
             leaf.fill, leaf.scale] for leaf in weights.leaves(conf, qk_gain)]


@pytest.mark.parametrize("name", CONFIGS)
def test_committed_configurations_are_decoders(name):
    assert bench.family_name(conf_of(name)) == "decoder"


@pytest.mark.parametrize("name", CONFIGS)
def test_leaves_are_the_parents_in_order(name):
    conf, pin = conf_of(name), PINS["configs"][name]
    assert table(conf) == pin["leaves"]
    assert sum(torch.Size(shape).numel() for _, shape, *_ in table(conf)) \
        == pin["params"]


def test_qk_gain_scales_only_the_query_and_key_projections():
    pin = PINS["configs"]["stablelm-3b"]["scales_at_qk_gain_1.5"]
    got = [[path, scale] for path, _, _, _, scale
           in table(conf_of("stablelm-3b"), 1.5) if scale != 1.0]
    assert got == pin


@pytest.mark.parametrize("name", CONFIGS)
def test_counts_are_the_parents_to_the_integer(name):
    conf, pin = conf_of(name), PINS["configs"][name]
    assert flops.train_step_flops(conf, 4, 4096) \
        == pin["train_step_flops_4x4096"]
    assert flops.serve_request_flops(conf, 3824, 16) \
        == pin["serve_request_flops_3824_16"]
    assert flops.adamw_bytes(
        (torch.Size(leaf.shape).numel(), leaf.dtype.itemsize)
        for leaf in weights.leaves(conf)) == pin["adamw_bytes"]


@pytest.mark.parametrize("name", CONFIGS)
def test_leaf_seeds_are_the_parents(name):
    n = len(PINS["configs"][name]["leaves"])
    assert [weights.leaf_seed(PINS["seed"], i) for i in range(n)] \
        == PINS["configs"][name]["leaf_seeds"]


def test_a_drawn_leaf_of_a_committed_configuration_is_the_parents():
    conf = conf_of("olmoe-1b-7b")
    path = "stack/layers/moe/router"
    pin = PINS["drawn"]["olmoe-1b-7b"][path]
    leaves = weights.leaves(conf)
    assert leaves[pin["index"]].path == path
    t = weights.draw(leaves[pin["index"]], pin["index"], PINS["seed"], "cpu")
    assert t.flatten()[:4].tolist() == pin["first"]
    assert float(t.double().sum()) == pytest.approx(pin["sum"], rel=1e-9)


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
def test_every_drawn_leaf_of_a_tiny_configuration_is_the_parents(name):
    pin = PINS["drawn_qk_gain_1.5"][name]
    drawn = weights.draw_all(tiny_conf(name), PINS["seed"], "cpu",
                             qk_gain=1.5)
    assert list(drawn) == list(pin)
    for path, t in drawn.items():
        assert t.flatten()[:3].float().tolist() == pin[path]["first"], path
        assert float(t.double().sum()) == pytest.approx(
            pin[path]["sum"], rel=1e-9, abs=1e-9), path


@pytest.mark.parametrize("family", FAMILIES)
def test_a_family_provides_what_the_harness_asks(family):
    mod = bench.family({"family": family})
    missing = [name for name in INTERFACE if not hasattr(mod, name)]
    assert not missing, missing
    assert set(mod.FIELDS) and all(isinstance(b, str) for b in mod.BLOCKS)
    for name in ("Spec", "train", "logits_at"):
        assert hasattr(mod.reference, name), name
