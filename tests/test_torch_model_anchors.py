"""``src/repro_torch/models/anchors_smoke.json``, the reference's smoke-size
outputs that ``chip_smoke.py``'s ``[model]`` phase and the card tests hold
the port to: the committed file equals a fresh reference run (JAX on the
CPU, params drawn by numpy), and the port on the CPU equals the file at
rtol = atol = 1e-4.  Rewrite the file with
``JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_torch_model_anchors.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_model_anchors import reference_outputs  # noqa: E402

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.convert import (numpy_params,  # noqa: E402
                                      params_from_numpy)
from repro_torch.models import anchors  # noqa: E402

PINNED = anchors.load()


def test_anchors_cover_every_arch():
    assert sorted(PINNED["archs"]) == sorted(ARCHS)
    assert (PINNED["param_seed"], PINNED["batch_seed"]) == \
        (anchors.PARAM_SEED, anchors.BATCH_SEED)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_pinned_anchors_equal_a_fresh_reference_run(arch):
    fresh = reference_outputs(arch)
    want = PINNED["archs"][arch]
    np.testing.assert_allclose(fresh["checksum"], want["checksum"],
                               rtol=1e-12, atol=0)
    # the file keeps 9 significant digits of float32 values
    assert anchors.mismatches(fresh, want, rtol=1e-5, atol=1e-6) == []


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_port_on_the_cpu_equals_the_pinned_anchors(arch):
    # the reference's anchors: the JAX package has no mixer norms
    cfg = get_config(arch, smoke=True).replace(mixer_rms_eps=None)
    tree = numpy_params(cfg, anchors.PARAM_SEED)
    want = dict(PINNED["archs"][arch])
    np.testing.assert_allclose(anchors.params_checksum(tree),
                               want.pop("checksum"), rtol=1e-12, atol=0)
    got = anchors.port_outputs(cfg, params_from_numpy(cfg, tree, "cpu"),
                               "cpu")
    assert anchors.mismatches(got, want, rtol=1e-4, atol=1e-4) == []


def test_mismatches_reports_each_kind_of_difference():
    want = {"a": [1.0, 2.0], "t": [[3, 4]], "s": [{"x": 0.5}]}
    assert anchors.mismatches(want, want, 0, 0) == []
    got = {"a": [1.0, 2.1], "t": [[3, 5]], "s": [{"x": 0.5}, {"x": 1.0}]}
    msgs = anchors.mismatches(got, want, 1e-3, 1e-3)
    assert [m.split(":")[0] for m in msgs] == ["/a", "/s", "/t"]
    assert anchors.mismatches({"a": [1.0]}, want, 0, 0)[0].startswith(
        ": keys")
