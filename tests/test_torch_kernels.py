"""The port's tiled matmul against the JAX package's: ``tiled_matmul_plain``
and ``ops.matmul`` on CPU tensors vs ``repro.kernels.ops.matmul`` (the
Pallas kernel in interpret mode, as tests/test_kernels.py runs it).  The
CUDA kernel itself is tested in tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import kernels as j_kernels  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.tiled_matmul import vmem_bytes  # noqa: E402

from repro_torch import kernels as t_kernels  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels import tiled_matmul as t_tm  # noqa: E402

# the smallest shape of tests/test_kernels.py::test_tiled_matmul_sweep
SHAPES = [(64, 64, 256, 32, 32, 128)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5, 1.6e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2, 0.16),
          "int8": (jnp.int8, torch.int8, 0.0, 0.0)}


def _inputs(m, n, k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return (rng.integers(-1, 2, (m, k)).astype(np.float32),
                rng.integers(-1, 2, (k, n)).astype(np.float32))
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


def _pair(a, dtype):
    jdt, tdt, _, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.as_tensor(a).to(tdt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("order", ["out", "a", "b"])
@pytest.mark.parametrize("m,n,k,bm,bn,bk", SHAPES)
def test_plain_matches_pallas_kernel(m, n, k, bm, bn, bk, order, dtype):
    xa, ya = _inputs(m, n, k, dtype)
    jx, tx = _pair(xa, dtype)
    jy, ty = _pair(ya, dtype)
    want = np.asarray(j_ops.matmul(jx, jy, bm=bm, bn=bn, bk=bk, order=order),
                      np.float32)
    rtol, atol = DTYPES[dtype][2:]
    plain = t_tm.tiled_matmul_plain(tx, ty, bm=bm, bn=bn, bk=bk, order=order)
    via_ops = t_ops.matmul(tx, ty, bm=bm, bn=bn, bk=bk, order=order)
    assert plain.dtype == via_ops.dtype == DTYPES[dtype][1]
    for got in (plain, via_ops):
        np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                                   atol=atol)


def test_int8_overflow_saturates_then_wraps_like_reference():
    """256 ones per dot: 'out' saturates the float32 sum once (127); 'a'/'b'
    saturate each 128-wide partial and add in int8, which wraps (-2)."""
    jx, jy = jnp.ones((8, 256), jnp.int8), jnp.ones((256, 8), jnp.int8)
    tx = torch.ones((8, 256), dtype=torch.int8)
    ty = torch.ones((256, 8), dtype=torch.int8)
    for order, want in (("out", 127), ("a", -2), ("b", -2)):
        j_got = np.asarray(j_ops.matmul(jx, jy, bm=8, bn=8, bk=128,
                                        order=order))
        t_got = t_ops.matmul(tx, ty, bm=8, bn=8, bk=128, order=order)
        assert (j_got == want).all() and (t_got.numpy() == want).all()
    assert (np.asarray(j_ref.matmul_ref(jx, jy)) == 127).all()
    assert (t_ref.matmul_ref(tx, ty).numpy() == 127).all()


def test_float_to_int8_casts_saturate_like_jax():
    vals = np.array([300.0, -300.0, 127.9, -128.9, 2.7, -2.7, 0.0],
                    np.float32)
    want = np.asarray(jnp.asarray(vals).astype(jnp.int8))
    got = t_kernels.cast(torch.as_tensor(vals), torch.int8).numpy()
    assert np.array_equal(got, want)
    # bits= threading casts the same way on both sides
    x = np.array([[300.0, -2.5]], np.float32)
    y = np.array([[1.0], [1.0]], np.float32)
    assert np.array_equal(
        t_ops.matmul(torch.as_tensor(x), torch.as_tensor(y), bm=1, bn=1,
                     bk=2, bits=8, use_kernel=False).numpy(),
        np.asarray(j_ops.matmul(jnp.asarray(x), jnp.asarray(y), bm=1, bn=1,
                                bk=2, bits=8, use_pallas=False)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ref_matches_reference_oracle(dtype):
    xa, ya = _inputs(48, 40, 96, dtype, seed=3)
    jx, tx = _pair(xa * 3, dtype)
    jy, ty = _pair(ya * 3, dtype)
    want = np.asarray(j_ref.matmul_ref(jx, jy), np.float32)
    got = t_ref.matmul_ref(tx, ty).float().numpy()
    rtol, atol = DTYPES[dtype][2:]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_width_helpers_and_smem_formula():
    assert t_kernels.SUPPORTED_BITS == j_kernels.SUPPORTED_BITS
    for kind in j_kernels.SUPPORTED_BITS:
        for bits in (2, 4, 8, 16, 32, 64):
            assert t_kernels.kernel_bits(bits, kind) == \
                j_kernels.kernel_bits(bits, kind)
    assert t_kernels.dtype_for_bits(4) == torch.int8
    assert t_kernels.dtype_for_bits(16) == torch.bfloat16
    assert t_kernels.dtype_for_bits(8, "mamba") == torch.float32
    for blocks in ((64, 64, 64), (128, 16, 3), (1, 1, 1)):
        for db in (1, 2, 4):
            assert t_tm.smem_bytes(*blocks, db) == vmem_bytes(*blocks, db)


def test_wrapper_validates_before_running():
    x = torch.ones((64, 32))
    with pytest.raises(ValueError, match="divide"):
        t_tm.tiled_matmul(x, torch.ones((32, 48)), bm=64, bn=32, bk=32)
    with pytest.raises(ValueError, match="dtypes"):
        t_tm.tiled_matmul(x, torch.ones((32, 48), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="order"):
        t_tm.tiled_matmul(x, torch.ones((32, 48)), order="c")
    with pytest.raises(ValueError, match=r"\(M,K\)"):
        t_tm.tiled_matmul(x, torch.ones((16, 48)))
    # blocks clamp to the dims, as in the reference
    got = t_tm.tiled_matmul(x, torch.ones((32, 48)), bm=512, bn=512, bk=512)
    assert torch.equal(got, torch.full((64, 48), 32.0))
    before = t_tm.tiled_matmul.launches
    t_tm.tiled_matmul(x, torch.ones((32, 48)))
    assert t_tm.tiled_matmul.launches == before   # CPU: plain, no launch
