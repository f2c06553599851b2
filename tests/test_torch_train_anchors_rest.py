"""The rest of ``test_torch_train_anchors.py``'s fresh reference runs: the
committed ``anchors_train_smoke.json`` equals a fresh run of the JAX
package's step factories for the architectures after the first six (split
so that neither file runs much over 45 s)."""
import pytest

pytest.importorskip("torch")

from _torch_train_anchors import (assert_pinned_equals_fresh,  # noqa: E402
                                  one_torch_thread)  # noqa: F401

from repro_torch.configs import ARCHS  # noqa: E402


@pytest.mark.parametrize("arch", sorted(ARCHS)[6:])
def test_pinned_anchors_equal_a_fresh_reference_run(arch):
    assert_pinned_equals_fresh(arch)
