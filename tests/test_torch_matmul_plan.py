"""The tiled matmul's launch plans, checked on the host for every config
the bridge can lower for BERT-base (``config_legal`` over all divisor
triples of each layer, all three orders).  float32 at 32 bits: micro-tiles
that cover the tile, whole warps, shared memory within the formula, and
16-byte copies only where the rows and addresses allow them.  bfloat16 and
int8 at 16 and 8 bits (the tensor-core plan): fragments that cover the tile
once, whole warps, regions disjoint and within the formula, and copies only
as wide as the rows and addresses allow.  Needs no jax and no card."""
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


def _legal_blocks(m, n, k, bits=32):
    wl = kb.matmul_workload(m, n, k)
    for block in itertools.product(_divisors(m), _divisors(n),
                                   _divisors(k)):
        if kb.config_legal(wl, kb.KernelConfig("matmul", block, "out",
                                               bits)):
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


def _mma_regions(plan, bm, bn, bk, item, order):
    """(start, end) bytes of every shared-memory region the plan lays out:
    the accumulator, the stationary tile, each ring stage's tiles."""
    xb, yb = bm * plan.x_ld * item, bk * plan.y_ld * item
    out = [] if plan.acc_in_regs else [(0, 4 * bm * bn)]
    stages = range(plan.stages)
    if order != "a":
        out += [(plan.xs_at + s * plan.stage_bytes,
                 plan.xs_at + s * plan.stage_bytes + xb) for s in stages]
    else:
        out.append((plan.xs_at, plan.xs_at + xb))
    if order != "b":
        out += [(plan.ys_at + s * plan.stage_bytes,
                 plan.ys_at + s * plan.stage_bytes + yb) for s in stages]
    else:
        out.append((plan.ys_at, plan.ys_at + yb))
    return out


def _fragments(plan):
    """Every (fragment row, fragment column) the warps own, pass by pass."""
    for pm, pn, wm, wn, a, b in itertools.product(
            range(plan.passes_m), range(plan.passes_n),
            range(plan.warps_m), range(plan.warps_n), range(plan.frag_m),
            range(plan.frag_n)):
        yield ((pm * plan.warps_m + wm) * plan.frag_m + a,
               (pn * plan.warps_n + wn) * plan.frag_n + b)


def check_mma_plan(plan, bm, bn, bk, item, order, x_ptr=0, y_ptr=0, m=0,
                   n=0):
    assert (plan.frag_m, plan.frag_n) in (
        tm.MMA_LAYOUTS if order == "out" else tm.MMA_LAYOUTS_AB)
    # whole warps, at most 8 a grid; up to 16 in copies of the grid that
    # share four steps an iteration
    grid = plan.warps_m * plan.warps_n
    assert 1 <= grid <= tm.MAX_MMA_WARPS
    copies = (min(tm.GROUP, tm.MAX_GROUP_WARPS // grid) if plan.group > 1
              else 1)
    assert tm.GROUP % copies == 0
    assert plan.threads == 32 * grid * copies <= 32 * tm.MAX_GROUP_WARPS
    # the fragments inside the tile, each once; together they hold every
    # output of the tile (16 x 8 outputs a fragment)
    fm_n, fn_n = -(-bm // 16), -(-bn // 8)
    inside = [f for f in _fragments(plan) if f[0] < fm_n and f[1] < fn_n]
    assert sorted(inside) == list(itertools.product(range(fm_n),
                                                    range(fn_n)))
    # no pass holds only fragments past the tile
    assert (plan.passes_m - 1) * plan.warps_m * plan.frag_m < fm_n
    assert (plan.passes_n - 1) * plan.warps_n * plan.frag_n < fn_n
    one_pass = plan.passes_m * plan.passes_n == 1
    assert plan.acc_in_regs == (order != "out" or one_pass)
    # four steps an iteration only for one-fragment warps in orders "a"/"b"
    # whose sweeps are whole iterations, through a ring of two of them
    sweep = (n // bn if order == "a" else m // bm) if m and n else 0
    assert plan.group in (1, tm.GROUP)
    if plan.group == tm.GROUP:
        assert (plan.frag_m, plan.frag_n) == (1, 1) and order != "out"
        assert one_pass and sweep % tm.GROUP == 0
        assert plan.stages in tm.GROUP_STAGES
    else:
        assert 1 <= plan.stages <= tm.MAX_STAGES
    formula = tm.smem_bytes(bm, bn, bk, item)
    assert 0 < plan.smem <= formula <= tm.SMEM_LIMIT_BYTES
    regions = sorted(_mma_regions(plan, bm, bn, bk, item, order))
    assert regions[0][0] >= 0 and regions[-1][1] == plan.smem
    assert all(a[1] <= b[0] for a, b in zip(regions, regions[1:]))
    assert plan.x_ld >= bk and plan.y_ld >= bn
    assert plan.stage_bytes >= (bm * plan.x_ld * item if order != "a"
                                else 0) + (bk * plan.y_ld * item
                                           if order != "b" else 0)
    # copies only as wide as rows, strides and addresses allow
    for width, row, ld, ptr, starts in (
            (plan.x_copy, bk * item, plan.x_ld * item, x_ptr,
             [r[0] for r in _mma_regions(plan, bm, bn, bk, item, order)
              if r[1] - r[0] == bm * plan.x_ld * item]),
            (plan.y_copy, bn * item, plan.y_ld * item, y_ptr,
             [r[0] for r in _mma_regions(plan, bm, bn, bk, item, order)
              if r[1] - r[0] == bk * plan.y_ld * item])):
        assert width in (0, 4, 8, 16)
        if width:
            assert row % width == 0 and ld % width == 0
            assert ptr % width == 0
            assert all(at % width == 0 for at in starts)
        else:
            # rows under 4 bytes, or misaligned: no cp.async at all
            assert any(v % 4 for v in (row, ld, ptr, *starts))
    if plan.x_word:
        assert (plan.x_ld * item) % 4 == 0
        assert plan.xs_at % 4 == 0 and plan.stage_bytes % 4 == 0


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_mma_plan_of_every_legal_bert_config(name, bits):
    m, n, k = LAYERS[name]
    item = bits // 8
    count = 0
    for bm, bn, bk in _legal_blocks(m, n, k, bits):
        for order in ORDERS:
            plan = tm.launch_plan(bm, bn, bk, item, order, m=m, n=n)
            assert isinstance(plan, tm.MmaPlan)
            check_mma_plan(plan, bm, bn, bk, item, order, m=m, n=n)
            count += 1
    assert count > 0


@pytest.mark.parametrize("bm,bn,bk,order,layout,warps,stages,acc_in_regs", [
    (64, 2, 16, "a", (1, 1), 4, 4, True),        # InFlex: 4 fragment rows
    (128, 256, 12, "out", (4, 8), 8, 4, True),
    (96, 256, 48, "out", (4, 8), 8, 3, True),
    (64, 64, 384, "b", (2, 2), 8, 1, True),
    (128, 128, 64, "out", (4, 4), 8, 2, True),   # padded beats 3 stages
    (192, 256, 16, "out", (4, 8), 8, 1, False),  # two passes
    (1, 512, 2, "out", (4, 8), 8, 1, True),
    (3, 5, 9, "b", (1, 1), 1, 1, True),
])
def test_mma_plans_of_the_main_path_shapes(bm, bn, bk, order, layout, warps,
                                           stages, acc_in_regs):
    plan = tm.launch_plan(bm, bn, bk, 2, order)
    assert plan.group == 1
    assert ((plan.frag_m, plan.frag_n), plan.warps_m * plan.warps_n,
            plan.stages, plan.acc_in_regs) == (layout, warps, stages,
                                               acc_in_regs)
    check_mma_plan(plan, bm, bn, bk, 2, order)


@pytest.mark.parametrize("item", [2, 1])
def test_thin_sweeps_run_four_steps_an_iteration(item):
    """The InFlex block (64,2,16) "a" at BERT ffn_up: 256 steps a sweep, so
    four an iteration through 16 stages (int8) or the 8 that fit
    (bfloat16); an odd sweep, or order "out", keeps one."""
    plan = tm.launch_plan(64, 2, 16, item, "a", m=3072, n=512)
    assert (plan.group, plan.stages) == (tm.GROUP, 16 if item == 1 else 8)
    check_mma_plan(plan, 64, 2, 16, item, "a", m=3072, n=512)
    assert tm.launch_plan(64, 2, 16, item, "a", m=3072, n=6).group == 1
    assert tm.launch_plan(64, 2, 16, item, "out", m=3072, n=512).group == 1
    # order "b": the moving x tiles must fit 8 stages beside y
    assert tm.launch_plan(16, 8, 2, item, "b", m=64, n=16).group == tm.GROUP
    assert tm.launch_plan(16, 4, 16, item, "b", m=128, n=16).group == 1


def test_mma_misaligned_operands_take_narrower_copies():
    for item in (2, 1):
        aligned = tm.launch_plan(64, 64, 32, item, "out")
        assert aligned.x_copy == aligned.y_copy == 16
        off = tm.launch_plan(64, 64, 32, item, "out", x_ptr=item,
                             y_ptr=3 * item)
        assert off.x_copy == off.y_copy == 0
        check_mma_plan(off, 64, 64, 32, item, "out", item, 3 * item)
        assert off._replace(x_copy=16, y_copy=16) == aligned
    # int8 rows of 2 bytes and bfloat16 rows of 2 bytes go through registers
    assert tm.launch_plan(64, 2, 16, 1, "a").y_copy == 0
    assert tm.launch_plan(64, 1, 16, 2, "a").y_copy == 0
    assert tm.launch_plan(64, 2, 16, 2, "a").y_copy == 4
