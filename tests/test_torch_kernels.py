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


# the int8 blocks the bridge lowers, at reduced widths (M, N, K, bm, bn, bk);
# every bk <= 1024, so no K-block's partial exceeds 1024 * 2^14 = 2^24
BRIDGE_INT8 = [(128, 8, 48, 64, 2, 16), (256, 512, 36, 128, 256, 12),
               (192, 512, 96, 96, 256, 48), (128, 128, 768, 64, 64, 384),
               (4, 1024, 6, 1, 512, 2), (9, 10, 27, 3, 5, 9)]


def _int8_exact(x, y, bk, order):
    """int64 products and sums, then the saturating cast: of all of K
    ("out") or of each K-block's partial, added in int8 with wrap-around
    ("a"/"b")."""
    x, y = x.astype(np.int64), y.astype(np.int64)
    if order == "out":
        return np.clip(x @ y, -128, 127).astype(np.int8)
    out = np.zeros((x.shape[0], y.shape[1]), np.int64)
    for k0 in range(0, x.shape[1], bk):
        partial = np.clip(x[:, k0:k0 + bk] @ y[k0:k0 + bk], -128, 127)
        out = (out + partial + 128) % 256 - 128
    return out.astype(np.int8)


@pytest.mark.parametrize("order", ["out", "a", "b"])
@pytest.mark.parametrize("m,n,k,bm,bn,bk", BRIDGE_INT8)
def test_full_range_int8_equals_reference_and_exact_arithmetic(
        m, n, k, bm, bn, bk, order):
    """Full-range int8 operands: the Pallas kernel (interpret mode) and the
    plain version agree exactly, and both equal exact integer arithmetic
    with the saturating cast.  Each K-block's float32 partial is exact
    because |partial| <= bk * 2^14 <= 2^24, and the running float32 sums of
    "out" stay far below 2^24 at these K; this is the condition under which
    the card kernel's int32 accumulation equals the reference."""
    rng = np.random.default_rng(5)
    xa = rng.integers(-128, 128, (m, k)).astype(np.int8)
    ya = rng.integers(-128, 128, (k, n)).astype(np.int8)
    assert bk * 2 ** 14 <= 2 ** 24
    want = np.asarray(j_ops.matmul(jnp.asarray(xa), jnp.asarray(ya), bm=bm,
                                   bn=bn, bk=bk, order=order))
    got = t_tm.tiled_matmul_plain(torch.as_tensor(xa), torch.as_tensor(ya),
                                  bm=bm, bn=bn, bk=bk, order=order).numpy()
    exact = _int8_exact(xa, ya, bk, order)
    assert np.array_equal(got, want)
    assert np.array_equal(got, exact)


def _past_2_to_24(seed=0):
    """int8 operands (M = N = 8, K = 3072) whose running sums pass 2^24:
    each x row is a run of +127 then a run of -127 (1041-1205 each, so
    127 * 127 * run > 2^24) against y rows of +-127 or 126, then a tail of
    -1/0/1 against y = 1.  Equal runs cancel and end inside [-128, 127];
    runs one apart saturate."""
    rng = np.random.default_rng(seed)
    k, head = 3072, 2410
    x = np.zeros((8, k), np.int64)
    for i in range(8):
        up = int(rng.integers(1041, 1206))
        down = up + (i % 3) - 1 if i % 4 == 3 else up
        x[i, :up] = 127
        x[i, up:up + down] = -127
        x[i, head:] = rng.integers(-1, 2, k - head)
    y = np.ones((k, 8), np.int64)
    y[:head] = rng.choice([127, -127, 126], size=8)[None, :]
    assert (np.abs(np.cumsum(x[:, :head, None] * y[None, :head], axis=1))
            .max() > 2 ** 24)
    return x.astype(np.int8), y.astype(np.int8)


@pytest.mark.parametrize("order", ["out", "a", "b"])
@pytest.mark.parametrize("bk", [3072, 1536])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_int8_running_sums_past_2_to_24(seed, bk, order):
    """The probe of the tiled_matmul.cu header's int8 claim: the
    reference's float32 sums pass 2^24 (within the first K-block at both
    bk).  The Pallas kernel (interpret mode), the plain version and exact
    int64 arithmetic with the saturating cast agree, in every order, at
    one K-block and at two (where "a"/"b" cast and add each partial)."""
    xa, ya = _past_2_to_24(seed)
    want = np.asarray(j_ops.matmul(jnp.asarray(xa), jnp.asarray(ya), bm=8,
                                   bn=8, bk=bk, order=order))
    got = t_tm.tiled_matmul_plain(torch.as_tensor(xa), torch.as_tensor(ya),
                                  bm=8, bn=8, bk=bk, order=order).numpy()
    exact = _int8_exact(xa, ya, bk, order)
    assert np.array_equal(want, exact)
    assert np.array_equal(got, exact)
