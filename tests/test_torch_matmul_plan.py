"""The float32 tiled matmul's launch plan, checked on the host for every
config the bridge can lower for BERT-base at 32 bits (``config_legal``
over all divisor triples of each layer, all three orders): micro-tiles
that cover the tile, whole warps, shared memory within the formula, and
16-byte copies only where the rows and addresses allow them.  bfloat16 and
int8 keep the first kernel's launch.  Needs no jax and no card."""
import itertools

import pytest

pytest.importorskip("torch")

from repro_torch.core import kernel_bridge as kb  # noqa: E402
from repro_torch.core.workloads import bert_base  # noqa: E402
from repro_torch.kernels import tiled_matmul as tm  # noqa: E402

ORDERS = ("out", "a", "b")
LAYERS = {layer.name: (layer.dims[0], layer.dims[2], layer.dims[1])
          for layer in bert_base()}


def _divisors(v):
    return [d for d in range(1, v + 1) if v % d == 0]


def _legal_blocks(m, n, k):
    wl = kb.matmul_workload(m, n, k)
    for block in itertools.product(_divisors(m), _divisors(n),
                                   _divisors(k)):
        if kb.config_legal(wl, kb.KernelConfig("matmul", block, "out", 32)):
            yield block


def _regions(plan, bm, bn, bk):
    """(start, end) bytes of every shared-memory region the plan lays out."""
    out = [] if plan.acc_in_regs else [(0, 4 * bm * bn)]
    for ys, xs in zip(plan.ys_at, plan.xs_at):
        out += [(ys, ys + 4 * bk * bn), (xs, xs + 4 * bm * plan.x_ld)]
    return out


def check_plan(plan, bm, bn, bk, order):
    assert plan.tm in tm.MICRO_EDGES and plan.tn in tm.MICRO_EDGES
    assert bm % plan.tm == 0 and bn % plan.tn == 0
    # the largest edge that divides: no larger one would
    assert all(bm % e for e in tm.MICRO_EDGES if e > plan.tm)
    assert all(bn % e for e in tm.MICRO_EDGES if e > plan.tn)
    units = (bm // plan.tm) * (bn // plan.tn)
    assert units * plan.tm * plan.tn == bm * bn
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    assert plan.threads >= min(units, 256)
    assert plan.threads < units + 32 or plan.threads == 32
    assert plan.acc_in_regs == (order != "out" or units <= plan.threads)
    assert plan.buffers in (1, 2) and len(plan.ys_at) == len(plan.xs_at) \
        == plan.buffers
    assert plan.buffers == 1 or plan.acc_in_regs
    formula = tm.smem_bytes(bm, bn, bk, 4)
    assert 0 < plan.smem <= formula <= tm.SMEM_LIMIT_BYTES
    regions = sorted(_regions(plan, bm, bn, bk))
    assert regions[0][0] >= 0 and regions[-1][1] <= plan.smem
    assert all(a[1] <= b[0] for a, b in zip(regions, regions[1:]))
    assert plan.x_ld >= bk
    if plan.x_vec:
        assert bk % 4 == 0 and plan.x_ld % 4 == 0
        assert all(at % 16 == 0 for at in plan.xs_at)
    if plan.x_copy16:
        assert plan.x_vec
    if plan.y_copy16:
        assert bn % 4 == 0 and all(at % 16 == 0 for at in plan.ys_at)
    # y rows (and accumulator rows) are read tn floats at a time, up to 4
    assert all(at % (4 * min(plan.tn, 4)) == 0 for at in plan.ys_at)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_plan_of_every_legal_bert_config(name):
    m, n, k = LAYERS[name]
    count = 0
    for bm, bn, bk in _legal_blocks(m, n, k):
        for order in ORDERS:
            check_plan(tm.launch_plan(bm, bn, bk, 4, order), bm, bn, bk,
                       order)
            count += 1
    assert count > 0


@pytest.mark.parametrize("bm,bn,bk,tm_,tn_,threads,acc_in_regs,buffers", [
    (96, 4, 16, 8, 4, 32, True, 1),        # thin: 12 micro-tiles
    (64, 2, 16, 8, 2, 32, True, 1),
    (128, 256, 12, 8, 8, 256, False, 1),   # accumulator in shared memory
    (1, 512, 2, 1, 8, 64, True, 1),
    (96, 128, 192, 8, 8, 192, True, 1),
    (128, 128, 32, 8, 8, 256, True, 2),    # copy overlaps the product
    (3, 5, 9, 1, 1, 32, True, 1),
])
def test_plans_of_the_main_path_shapes(bm, bn, bk, tm_, tn_, threads,
                                       acc_in_regs, buffers):
    plan = tm.launch_plan(bm, bn, bk, 4, "out")
    assert (plan.tm, plan.tn, plan.threads, plan.acc_in_regs,
            plan.buffers) == (tm_, tn_, threads, acc_in_regs, buffers)
    check_plan(plan, bm, bn, bk, "out")
    # orders "a"/"b" keep each K-block's partial in registers
    assert tm.launch_plan(bm, bn, bk, 4, "a").acc_in_regs


def test_micro_tiles_cover_the_tile_once():
    """Thread (uy, ux) owns rows uy + s*bm/tm and columns in 4-wide slabs
    bn*4/tn apart (tn >= 4) or tn neighbours: every output of the tile
    once."""
    for bm, bn in ((96, 4), (64, 2), (128, 256), (1, 512), (24, 32),
                   (3, 5), (40, 24)):
        plan = tm.launch_plan(bm, bn, 16, 4, "out")
        rows, cols = bm // plan.tm, bn // plan.tn
        seen = []
        for uy, ux in itertools.product(range(rows), range(cols)):
            if plan.tn >= 4:
                slab = bn * 4 // plan.tn
                cs = [g * slab + ux * 4 + t for g in range(plan.tn // 4)
                      for t in range(4)]
            else:
                cs = [ux * plan.tn + t for t in range(plan.tn)]
            seen += [(uy + s * rows, c) for s in range(plan.tm) for c in cs]
        assert sorted(seen) == list(itertools.product(range(bm), range(bn)))


def test_misaligned_operands_take_4_byte_copies():
    aligned = tm.launch_plan(64, 64, 32, 4, "out")
    assert aligned.x_copy16 and aligned.y_copy16
    off = tm.launch_plan(64, 64, 32, 4, "out", x_ptr=4, y_ptr=8)
    assert not off.x_copy16 and not off.y_copy16
    assert off._replace(x_copy16=True, y_copy16=True) == aligned
    # rows of 2 or 6 floats cannot take 16-byte copies
    odd = tm.launch_plan(64, 2, 6, 4, "out")
    assert not odd.x_copy16 and not odd.y_copy16 and not odd.x_vec


@pytest.mark.parametrize("dtype_bytes", [2, 1])
def test_bf16_and_int8_keep_the_first_launch(dtype_bytes):
    for bm, bn, bk in ((64, 64, 64), (96, 4, 16), (128, 256, 12),
                       (1, 512, 2)):
        for order in ORDERS:
            plan = tm.launch_plan(bm, bn, bk, dtype_bytes, order)
            assert plan.threads == 256 and plan.buffers == 1
            assert not plan.acc_in_regs
            assert plan.smem == tm.smem_bytes(bm, bn, bk, dtype_bytes)
            assert plan.xs_at == (4 * bm * bn,)
            assert plan.ys_at == (4 * bm * bn + bm * bk * dtype_bytes,)
