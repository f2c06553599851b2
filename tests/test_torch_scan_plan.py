"""The selective scan's launch plans (``mamba_scan.scan_plan``), checked on
the host for every (chunk, d_block) the bridge can lower for the
falcon-mamba-7b scan (``config_legal`` over all divisor pairs at batch 1,
seq 4096, d_inner 8192, d_state 16), the small shapes of the CPU parity
tests, and d_state from 1 to 128: whole warps, at most 8 CTAs a d-block,
shared memory within the mapping's formula, and every (channel, state) of
a d-block owned by exactly one thread of one pass of one CTA.  Needs no
jax and no card."""
import itertools

import pytest

pytest.importorskip("torch")

from repro_torch.core import kernel_bridge as kb  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402

FALCON = (1, 4096, 8192, 16)
# tests/test_torch_attention_mamba.py's scan shapes (B, L, D, N, chunk,
# d_block)
SMALL = [(1, 32, 16, 8, 8, 8), (2, 64, 32, 16, 16, 16),
         (2, 128, 64, 8, 32, 32)]
STATE_SIZES = (1, 5, 8, 16, 33, 128)
STATE_BLOCKS = [(16, 8), (16, 64), (4, 3), (256, 512), (8, 4096), (1, 1)]


def _divisors(v):
    return [d for d in range(1, v + 1) if v % d == 0]


def _falcon_blocks():
    wl = kb.mamba_workload(*FALCON)
    return [blk for blk in itertools.product(_divisors(FALCON[1]),
                                             _divisors(FALCON[2]))
            if kb.config_legal(wl, kb.KernelConfig("mamba", blk, "", 32))]


def _owners(plan, d_block, n):
    """(channel, state) -> owners across the CTAs of one d-block, their
    passes and their threads, as the kernel assigns them."""
    share = d_block // plan.split
    seen = {}
    for rank in range(plan.split):
        for p in range(plan.passes):
            width = min(plan.channels, share - p * plan.channels)
            assert width >= 1
            for tid in range(plan.threads):
                g, lane = divmod(tid, plan.lanes)
                if g >= width:            # idle thread: writes nothing
                    continue
                ch = rank * share + p * plan.channels + g
                for i in range(plan.states):
                    s = lane * plan.states + i
                    if s < n:
                        seen.setdefault((ch, s), []).append((rank, p, tid))
    return seen


def check_plan(chunk, d_block, n, plan):
    assert plan.states in ms.STATES
    assert plan.lanes <= 32 and plan.lanes & (plan.lanes - 1) == 0
    assert plan.states * plan.lanes == ms._pow2(n)
    assert plan.threads % 32 == 0
    assert plan.channels * plan.lanes <= plan.threads <= ms.PLAN_THREADS
    assert plan.threads < plan.channels * plan.lanes + 32
    assert 1 <= plan.split <= ms.MAX_SPLIT
    assert d_block % plan.split == 0
    # a split exactly where one CTA cannot stage the whole d-block
    group = ms.cta_channels(d_block, n)
    assert group <= ms.channel_group(d_block, n)
    assert (plan.split > 1) == (d_block > group)
    share = d_block // plan.split
    assert plan.channels <= min(share, group)
    assert plan.passes == -(-share // plan.channels)
    # shared memory: one buffer of b, c, x and dt, within the formula the
    # bridge's legality tests
    assert plan.smem == 4 * chunk * (2 * n + 2 * plan.channels)
    assert plan.smem <= ms.smem_bytes(chunk, d_block, n, 4)
    assert (plan.stage == ms.STAGE_SYNC) == (
        chunk == 1 and plan.stage != ms.STAGE_REGISTERS)
    if plan.stage == ms.STAGE_REGISTERS:
        # one vector of each operand a thread
        assert chunk * plan.channels // plan.vec_x <= plan.threads
        assert chunk * n // plan.vec_bc <= plan.threads
    # 16-byte copies only where every row and offset is 16-byte aligned
    if plan.vec_x == 4:
        assert plan.channels % 4 == 0 and share % 4 == 0
        assert (2 * chunk * n) % 4 == 0
    if plan.vec_bc == 4:
        assert n % 4 == 0
    seen = _owners(plan, d_block, n)
    assert len(seen) == d_block * n
    assert all(len(owners) == 1 for owners in seen.values())


@pytest.mark.parametrize("chunk,d_block", _falcon_blocks())
def test_falcon_blocks_plan(chunk, d_block):
    n = FALCON[3]
    check_plan(chunk, d_block, n, ms.scan_plan(chunk, d_block, n))


@pytest.mark.parametrize("bsz,length,dim,n,chunk,d_block", SMALL)
def test_small_shapes_plan(bsz, length, dim, n, chunk, d_block):
    check_plan(chunk, d_block, n, ms.scan_plan(chunk, d_block, n))


@pytest.mark.parametrize("chunk,d_block", STATE_BLOCKS)
@pytest.mark.parametrize("n", STATE_SIZES)
def test_every_state_size_plans(n, chunk, d_block):
    plan = ms.scan_plan(chunk, d_block, n)
    check_plan(chunk, d_block, n, plan)
    assert ms.scan_plan(chunk, d_block, n, aligned=False).vec_x == 1


def test_falcon_plans_take_every_stage_and_a_full_split():
    plans = {blk: ms.scan_plan(*blk, 16) for blk in _falcon_blocks()}
    assert {p.stage for p in plans.values()} == {
        ms.STAGE_REGISTERS, ms.STAGE_HALVES}
    # falcon-mamba-7b's d_block = 512 is one pass of 8 CTAs; 4096 is 8 CTAs
    assert plans[(16, 512)][4:6] == (8, 1)
    assert plans[(8, 4096)][4:6] == (8, 8)
    # the tuned config: a warp of 8 channels, 4 states a thread
    assert plans[(16, 8)][:5] == (4, 4, 8, 32, 1)


# the (states, lanes) pairs csrc/mamba_scan.cu instantiates
KERNEL_PAIRS = ({(s, lanes) for s in (1, 2, 4)
                 for lanes in (1, 2, 4, 8, 16, 32)}
                | {(8, 8), (8, 16), (16, 8)})


@pytest.mark.parametrize("n", range(1, ms.MAX_STATE + 1))
def test_every_plan_has_a_kernel(n):
    """At every d_state and every d_block up to 300 (every channel count a
    CTA may run), the plan's (states, lanes) is one the kernel is built
    for."""
    for d_block in range(1, 301):
        plan = ms.scan_plan(1, d_block, n)
        assert (plan.states, plan.lanes) in KERNEL_PAIRS, (d_block, plan)
