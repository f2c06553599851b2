"""The flash attention's launch plans (``flash_attention.attention_plan``),
checked on the host for every (bq, bkv) the bridge can lower for BERT-base
attention (``config_legal`` over all divisor pairs at 12 heads, seq 512,
head_dim 64, at 32 and 16 bits) and for bridge_validation's
``attention_workload(1, 32, 16)``, the shapes of the kernel sweeps and of
the CPU parity tests, and head widths 16 to 128: whole warps, at most 8
CTAs a q-block, shared memory within the mapping's formula, every row of a
q-block owned by exactly one (CTA, warp, row slot), every key of a KV
block computed once for each row, and every output column stored once.
Needs no jax and no card."""
import itertools

import pytest

pytest.importorskip("torch")

from repro_torch.core import kernel_bridge as kb  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

BERT = (12, 512, 64)
# chip_smoke.ATTN_SWEEP, tests/test_torch_cuda.py's ATTN_SHAPES and
# tests/test_torch_attention_mamba.py's attention shapes (h, sq, skv, d,
# bq, bkv)
SHAPES = [(2, 128, 128, 64, 64, 64), (4, 64, 256, 32, 32, 64),
          (1, 256, 256, 128, 128, 128), (2, 96, 96, 32, 3, 96),
          (2, 64, 64, 16, 1, 1), (12, 512, 512, 64, 256, 16),
          (2, 64, 64, 64, 16, 1), (2, 64, 64, 32, 32, 2),
          (2, 64, 64, 64, 1, 32), (2, 256, 256, 64, 128, 32),
          (2, 128, 128, 64, 64, 4), (2, 64, 64, 16, 16, 32),
          (2, 128, 128, 128, 32, 64), (2, 48, 48, 64, 48, 3),
          (2, 64, 128, 32, 16, 32), (2, 128, 64, 32, 32, 16),
          (1, 32, 2048, 16, 16, 1024), (1, 32, 32, 256, 16, 16),
          (2, 32, 48, 12, 8, 16), (1, 16, 16, 7, 4, 4),
          (12, 512, 512, 64, 256, 2), (2, 64, 256, 64, 2, 128),
          (2, 48, 48, 16, 3, 48),
          (1, 32, 32, 16, 1, 1)]
HEAD_DIMS = (16, 32, 64, 128)
DIM_BLOCKS = [(1, 1), (1, 256), (3, 96), (16, 128), (32, 16), (64, 2),
              (128, 8), (256, 256), (512, 64)]


def _divisors(v):
    return [d for d in range(1, v + 1) if v % d == 0]


def _bert_blocks(bits):
    wl = kb.attention_workload(*BERT)
    return [blk for blk in itertools.product(_divisors(BERT[1]), repeat=2)
            if kb.config_legal(wl, kb.KernelConfig("attention", blk, "",
                                                    bits))]


# bridge_validation's attention: attention_workload(1, 32, 16)
BRIDGE = (1, 32, 16)


def _bridge_blocks(bits):
    """Every (bq, bkv) legal at the bridge_validation shape and width — a
    superset of what its sampled genomes lower to."""
    wl = kb.attention_workload(*BRIDGE)
    return [blk for blk in itertools.product(_divisors(BRIDGE[1]), repeat=2)
            if kb.config_legal(wl, kb.KernelConfig("attention", blk, "",
                                                    bits))]


def _layout_bytes(plan, bq, bkv, d, dtype_bytes):
    """csrc/flash_attention.cu's layout: q, the p slices, K and V."""
    q = -(-4 * (bq // plan.split) * d // 16) * 16
    p = 0 if plan.lanes == 1 else -(-8 * (plan.threads // 32)
                                    * plan.warp_rows * plan.key_lanes
                                    // 16) * 16
    bufs = {fa.STAGE_DIRECT: 0, fa.STAGE_SPLIT: 1, fa.STAGE_DOUBLE: 2}[
        plan.stage]
    return q + p + 2 * bufs * plan.run * bkv * d * dtype_bytes


def check_plan(bq, bkv, d, dtype_bytes, plan, aligned=True):
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= fa.PLAN_THREADS
    assert (plan.vec, plan.rows, plan.keys) in fa.KERNEL_SHAPES
    assert plan.vec == (4 if aligned and d % 4 == 0 else 1)
    slabs = d // plan.vec
    lanes, kq, lrc = plan.lanes, plan.key_lanes, plan.col_lanes
    for v in (lanes, kq, lrc):
        assert v & (v - 1) == 0 and 1 <= v <= 32
    dq, lrk = lanes // kq, lanes // lrc
    assert lanes % kq == 0 and kq <= bkv and slabs % dq == 0
    assert lanes % lrc == 0 and kq % lrk == 0
    groups = 32 // lanes
    assert plan.warp_rows == groups * plan.rows
    assert 1 <= plan.split <= fa.MAX_SPLIT and bq % plan.split == 0
    cta_rows = bq // plan.split
    warps = plan.threads // 32
    assert warps == -(-cta_rows // plan.warp_rows)
    assert plan.rows * plan.keys <= fa.LOGIT_REGS
    assert plan.col_passes == -(-slabs // lrc)
    assert plan.chunks == -(-bkv // (kq * plan.keys))
    assert plan.run >= 1 and plan.stage in (
        fa.STAGE_SPLIT, fa.STAGE_DOUBLE, fa.STAGE_DIRECT)
    # a CTA of few rows at wide blocks reads K and V from device memory,
    # others stage them
    assert (plan.stage == fa.STAGE_DIRECT) == (
        bq // plan.split <= fa.DIRECT_ROWS and bkv >= fa.DIRECT_KEYS)
    if plan.run > 1:
        assert plan.stage == fa.STAGE_DOUBLE
        assert plan.run * bkv <= max(bkv, fa.RUN_KEYS)
    # shared memory: the layout the kernel checks, within the formula the
    # bridge's legality tests
    assert plan.smem == _layout_bytes(plan, bq, bkv, d, dtype_bytes)
    assert plan.smem <= fa.smem_bytes(bq, bkv, d, dtype_bytes)
    # every row of the q-block: one (CTA, warp, row slot) in each column
    # pass; slot = warp * warp_rows + i * groups + group
    rows = {}
    for part in range(plan.split):
        for w, i, g in itertools.product(range(warps), range(plan.rows),
                                         range(groups)):
            slot = w * plan.warp_rows + i * groups + g
            if slot < cta_rows:
                rows.setdefault(part * cta_rows + slot, []).append(
                    (part, w, i, g))
    assert sorted(rows) == list(range(bq))
    assert all(len(owners) == 1 for owners in rows.values())
    # every key of a block once for each row: key lanes x keys a lane x
    # chunks, the rest of the row's lanes splitting d (each slab once)
    keys = [ch * kq * plan.keys + t * kq + k
            for ch in range(plan.chunks) for t in range(plan.keys)
            for k in range(kq)]
    assert len(set(keys)) == len(keys)
    assert set(range(bkv)) <= set(keys)
    assert sorted(j * dq + r for j in range(slabs // dq)
                  for r in range(dq)) == list(range(slabs))
    # P.V: each key of a slice multiplied once, by one key group of lanes
    u = kq // lrk
    assert sorted(g * u + j for g in range(lrk) for j in range(u)) == \
        list(range(kq))
    # every output slab stored once: (column pass, column lane)
    stored = [p * lrc + c for p in range(plan.col_passes)
              for c in range(lrc) if p * lrc + c < slabs]
    assert sorted(stored) == list(range(slabs))


@pytest.mark.parametrize("bq,bkv", _bert_blocks(32))
def test_bert_blocks_plan_float32(bq, bkv):
    d = BERT[2]
    check_plan(bq, bkv, d, 4, fa.attention_plan(bq, bkv, d, 4))


@pytest.mark.parametrize("bq,bkv", _bert_blocks(16))
def test_bert_blocks_plan_bfloat16(bq, bkv):
    d = BERT[2]
    check_plan(bq, bkv, d, 2, fa.attention_plan(bq, bkv, d, 2))


@pytest.mark.parametrize("bits,dtype_bytes", [(32, 4), (16, 2)])
def test_bridge_validation_blocks_plan(bits, dtype_bytes):
    d = BRIDGE[2]
    blocks = _bridge_blocks(bits)
    assert len(blocks) == 6 * 6           # every divisor pair is legal
    for bq, bkv in blocks:
        for aligned in (True, False):
            check_plan(bq, bkv, d, dtype_bytes,
                       fa.attention_plan(bq, bkv, d, dtype_bytes, aligned),
                       aligned=aligned)


def test_bridge_validation_lowers_inside_the_planned_blocks():
    """The configs bridge_validation's sampled genomes lower to (R open:
    float32 and bfloat16) are among the blocks planned above."""
    import numpy as np
    from repro_torch.core import (lower_mapping, make_variant,
                                  mapspace_for)
    from repro_torch.kernels import kernel_bits
    wl = kb.attention_workload(*BRIDGE)
    space = mapspace_for(wl.layer, make_variant("11001"))
    genomes = space.clip(space.sample(np.random.default_rng(5), 4))
    lowered = {lower_mapping(wl, space.decode(g)) for g in genomes}
    assert lowered
    for cfg in lowered:
        assert cfg.block in _bridge_blocks(kernel_bits(cfg.bits,
                                                       "attention"))


@pytest.mark.parametrize("dtype_bytes", [4, 2])
@pytest.mark.parametrize("h,sq,skv,d,bq,bkv", SHAPES)
def test_sweep_shapes_plan(h, sq, skv, d, bq, bkv, dtype_bytes):
    check_plan(bq, bkv, d, dtype_bytes,
               fa.attention_plan(bq, bkv, d, dtype_bytes))
    check_plan(bq, bkv, d, dtype_bytes,
               fa.attention_plan(bq, bkv, d, dtype_bytes, aligned=False),
               aligned=False)


@pytest.mark.parametrize("bq,bkv", DIM_BLOCKS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_every_head_width_plans(d, bq, bkv):
    for dtype_bytes in (4, 2):
        if fa.smem_bytes(bq, bkv, d, dtype_bytes) <= fa.SMEM_LIMIT_BYTES:
            check_plan(bq, bkv, d, dtype_bytes,
                       fa.attention_plan(bq, bkv, d, dtype_bytes))


def test_bert_plans_fill_the_card_at_wide_q_blocks():
    plans = {blk: fa.attention_plan(*blk, 64, 4) for blk in _bert_blocks(32)}
    # q-blocks split so that each CTA owns 16 rows, 32 where a K/V block
    # takes more than 64 KB (at most 8 CTAs: 64 rows at bq = 512)
    for (bq, bkv), plan in plans.items():
        most = 32 if 2 * bkv * 64 * 4 > 65_536 else 16
        assert bq // plan.split == min(bq, max(most, bq // fa.MAX_SPLIT))
    # the tuned config: 4 warps of 2 rows a thread, 8 keys a lane
    assert plans[(16, 128)][:8] == (128, 4, 2, 16, 16, 16, 8, 4)
    # the max-block default: 8 CTAs a q-block, 32 lanes a row, each with
    # whole dot products of 8 keys
    assert plans[(256, 256)][:9] == (256, 4, 4, 32, 32, 16, 8, 4, 8)
    # thin blocks: the lanes of a row split d, runs of blocks double
    # buffered
    thin = plans[(256, 2)]
    assert (thin.key_lanes, thin.lanes, thin.stage) == (
        2, 16, fa.STAGE_DOUBLE)
    assert thin.run * 2 >= 32
    assert {p.stage for p in plans.values()} == {
        fa.STAGE_SPLIT, fa.STAGE_DOUBLE, fa.STAGE_DIRECT}


@pytest.mark.parametrize("dtype_bytes", [4, 2])
@pytest.mark.parametrize("d", range(1, 161))
def test_every_plan_has_a_kernel(d, dtype_bytes):
    """At every head width up to 160 and blocks from 1 to 512 (the formula
    allowing), the plan's (vec, rows, keys) is one the kernel is built for
    and its layout fits the formula."""
    for bq, bkv in itertools.product((1, 2, 3, 16, 48, 64, 512),
                                     (1, 3, 16, 96, 256, 512)):
        if fa.smem_bytes(bq, bkv, d, dtype_bytes) > fa.SMEM_LIMIT_BYTES:
            continue
        for aligned in (True, False):
            plan = fa.attention_plan(bq, bkv, d, dtype_bytes, aligned)
            assert (plan.vec, plan.rows, plan.keys) in fa.KERNEL_SHAPES
            assert plan.smem == _layout_bytes(plan, bq, bkv, d, dtype_bytes)
            assert plan.smem <= fa.smem_bytes(bq, bkv, d, dtype_bytes)
