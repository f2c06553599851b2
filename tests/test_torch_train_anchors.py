"""``src/repro_torch/models/anchors_train_smoke.json``, the reference's
smoke-size training outputs that ``chip_smoke.py``'s ``[train]`` phase and
the card tests hold the port to: the committed file equals a fresh
reference run (the JAX package's step factories under ``jax.jit`` on the
CPU; within 1e-3 of the anchors' own tolerances, as the file keeps 10
significant digits), and the port on the CPU equals the file at the
tolerances of ``train_anchors.compare``: losses at 1e-5, gradient norms at
1e-4 relative and entries at 1e-4 of the leaf's largest |g|, params
summaries at 1e-4 relative.  The fresh reference runs are split over this
file (the first six architectures) and
``test_torch_train_anchors_rest.py`` (the rest), ~45 s each.  Rewrite the
file with ``JAX_PLATFORMS=cpu PYTHONPATH=src python
tests/_torch_train_anchors.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_train_anchors import (assert_pinned_equals_fresh,  # noqa: E402
                                  one_torch_thread)  # noqa: F401

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.convert import numpy_params  # noqa: E402
from repro_torch.models import anchors  # noqa: E402
from repro_torch.models import train_anchors as TA  # noqa: E402

PINNED = TA.load()
FIRST = sorted(ARCHS)[:6]


def test_anchors_cover_every_arch():
    assert sorted(PINNED["archs"]) == sorted(ARCHS)
    assert (PINNED["param_seed"], PINNED["data_seed"], PINNED["batch"],
            PINNED["seq"]) == (TA.PARAM_SEED, TA.DATA_SEED, TA.BATCH,
                               TA.SEQ)


@pytest.mark.parametrize("arch", FIRST)
def test_pinned_anchors_equal_a_fresh_reference_run(arch):
    assert_pinned_equals_fresh(arch)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_port_on_the_cpu_equals_the_pinned_anchors(arch):
    # the reference's anchors: the JAX package has no mixer norms
    cfg = get_config(arch, smoke=True).replace(mixer_rms_eps=None)
    tree = numpy_params(cfg, TA.PARAM_SEED)
    # the same params as the model anchors (their checksum)
    np.testing.assert_allclose(
        anchors.params_checksum(tree),
        anchors.load()["archs"][arch]["checksum"], rtol=1e-12, atol=0)
    bad, share = TA.compare(TA.port_outputs(cfg, tree, "cpu"),
                            PINNED["archs"][arch])
    assert not bad, bad
    assert share <= 1.0


def test_compare_reports_each_kind_of_difference():
    want = PINNED["archs"]["gemma-2b"]
    assert TA.compare(want, want) == ([], 0.0)
    got = {**want, "loss": want["loss"] * (1 + 1e-4),
           "train": {**want["train"],
                     "losses": [x + 1e-3 for x in want["train"]["losses"]]}}
    bad, share = TA.compare(got, want)
    assert [b.split(":")[0] for b in bad] == ["loss", "train/losses"]
    assert share > 1.0
    got["grads"] = {k: v for k, v in want["grads"].items() if k != "embed"}
    assert TA.compare(got, want)[0][-1].startswith("grads: leaves")
