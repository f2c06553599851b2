"""The port's dry-run against the reference's on the train cells of one
dense, one MoE, one SSM and one hybrid smoke architecture on a (2, 2) mesh
(see ``test_torch_dryrun.py`` and ``tests/_torch_dryrun_ref.py``)."""
import pytest

import _torch_dryrun_ref as helper
from test_torch_dryrun import FLOP_BAND

KINDS = ["train"]
CELLS = [f"{a}/{k}" for a in helper.ARCHS for k in KINDS]


@pytest.fixture(scope="module")
def sides():
    result = helper.start_reference(KINDS)
    port = helper.port(KINDS)
    return result(), port


@pytest.mark.parametrize("cell", CELLS)
def test_argument_bytes_equal_the_reference(sides, cell):
    ref, port = sides
    assert port[cell]["argument_bytes"] == ref[cell]["argument_bytes"]


@pytest.mark.parametrize("cell", CELLS)
def test_output_bytes_equal_the_reference(sides, cell):
    """XLA's output size also counts the output tuple's table: one 8-byte
    pointer a leaf of the flattened outputs."""
    ref, port = sides
    p = port[cell]
    assert p["output_bytes"] + 8 * p["output_leaves"] == \
        ref[cell]["output_bytes"]


@pytest.mark.parametrize("cell", CELLS)
def test_flops_within_the_band_of_xla(sides, cell):
    ref, port = sides
    for n in (1, 2):
        ratio = port[cell][f"flops{n}"] / ref[cell][f"flops{n}"]
        assert FLOP_BAND[0] <= ratio <= FLOP_BAND[1], (n, ratio)
