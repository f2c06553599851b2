"""The Hopper kernels on the card against their plain PyTorch versions.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one.  They import no jax, so they run on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import tiled_matmul as tm  # noqa: E402

# tests/test_kernels.py::test_tiled_matmul_sweep's shapes
SHAPES = [(128, 128, 128, 64, 64, 64), (256, 192, 64, 64, 64, 32),
          (64, 64, 256, 32, 32, 128), (128, 256, 128, 128, 128, 128)]
DTYPES = {"float32": (torch.float32, 2e-5, 1.6e-4),
          "bfloat16": (torch.bfloat16, 2e-2, 0.16),
          "int8": (torch.int8, 0.0, 0.0)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _operands(m, n, k, dtype, device):
    rng = np.random.default_rng(0)
    if dtype == "int8":
        xs = rng.integers(-1, 2, (m, k)), rng.integers(-1, 2, (k, n))
    else:
        xs = rng.normal(size=(m, k)), rng.normal(size=(k, n))
    tdt = DTYPES[dtype][0]
    return tuple(torch.as_tensor(a.astype(np.float32)).to(device).to(tdt)
                 for a in xs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("order", ["out", "a", "b"])
@pytest.mark.parametrize("m,n,k,bm,bn,bk", SHAPES)
def test_kernel_matches_plain(m, n, k, bm, bn, bk, order, dtype, card):
    x, y = _operands(m, n, k, dtype, card)
    before = tm.tiled_matmul.launches
    got = ops.matmul(x, y, bm=bm, bn=bn, bk=bk, order=order)
    assert tm.tiled_matmul.launches == before + 1
    want = tm.tiled_matmul_plain(x, y, bm=bm, bn=bn, bk=bk, order=order)
    _, rtol, atol = DTYPES[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
def test_int8_overflow_on_the_card(card):
    x = torch.ones((8, 256), dtype=torch.int8, device=card)
    y = torch.ones((256, 8), dtype=torch.int8, device=card)
    for order, want in (("out", 127), ("a", -2), ("b", -2)):
        got = tm.tiled_matmul(x, y, bm=8, bn=8, bk=128, order=order)
        assert bool((got == want).all())


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(card):
    x = torch.ones((64, 64), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        tm.tiled_matmul(x.t(), x)
    with pytest.raises(ValueError, match="shared memory"):
        tm.tiled_matmul(torch.ones((512, 512), device=card),
                        torch.ones((512, 512), device=card),
                        bm=512, bn=512, bk=512)
