"""The port's ``launch/hloutil.py`` against ``repro.launch.hloutil``: the
HLO-text parser and the roofline formula (the reference's, run with the
port's constants), and the port's own counts of a sharded step: the
collective recorder, per-device FLOPs and bytes accessed, on fake
``DeviceMesh``es of (2, 2) and (16, 16) ranks."""
import pytest
import torch

import repro.launch.hloutil as ref
import repro_torch.launch.hloutil as port
from repro_torch.launch.dryrun import _fake_world

HLO = """
  %ag = bf16[64,1024]{1,0} all-gather(%p0), replica_groups={}
  %add = f32[8]{0} add(%a, %b)
  %ar = (f32[16,16]{1,0}, f32[16,16]{1,0}) all-reduce-start(%x, %y)
  ROOT %rs = f32[256]{0} reduce-scatter(%z), channel_id=4
  %a2a = bf16[24,448,7168]{2,1,0} all-to-all(%w), channel_id=9
  %cp = u32[128]{0} collective-permute(%q), channel_id=11
"""


def test_collective_bytes_parser_equals_the_reference():
    assert port.collective_bytes(HLO) == ref.collective_bytes(HLO)
    assert port.collective_bytes(HLO)["all-to-all"] == 24 * 448 * 7168 * 2


def test_constants_are_the_h100_data_sheet():
    assert (port.PEAK_FLOPS, port.HBM_BW, port.ICI_BW, port.ICI_LINKS) == \
        (989e12, 3.35e12, 25e9, 18)
    assert port._DTYPE_BYTES == ref._DTYPE_BYTES


@pytest.mark.parametrize("flops,hbm,coll", [
    (989e12, 1e9, 1e6),            # compute-dominated
    (1e9, 6.7e12, 1e6),            # memory-dominated
    (1e9, 1e9, 9e11),              # collective-dominated
    (0.0, 0.0, 0.0),               # all zeros
])
def test_roofline_terms_equal_the_reference(monkeypatch, flops, hbm, coll):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW", "ICI_LINKS"):
        monkeypatch.setattr(ref, name, getattr(port, name))
    want = ref.roofline_terms(flops, hbm, coll)
    got = port.roofline_terms(flops, hbm, coll)
    assert got == want
    if flops or hbm or coll:
        assert got["dominant"] == ["compute", "memory", "collective"][
            [flops / 989e12, hbm / 3.35e12, coll / 450e9].index(
                max(flops / 989e12, hbm / 3.35e12, coll / 450e9))]


def _mesh_cases():
    return [((2, 2), 2), ((16, 16), 16)]


@pytest.mark.parametrize("shape,n", _mesh_cases())
def test_recorder_counts_result_bytes_by_kind(shape, n):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    rows, cols = 4 * n, 8 * n
    with _fake_world(shape, ("data", "model"), "cpu") as mesh:
        # Shard(0) over 'data' -> Replicate: one all-gather, the whole
        # (rows, cols) float32 tensor its result
        x = DTensor.from_local(torch.empty(rows // n, cols), mesh,
                               [Shard(0), Replicate()], run_check=False)
        with port.CostRecorder() as rec:
            x.redistribute(mesh, [Replicate(), Replicate()])
        assert rec.collectives == {"all-gather": rows * cols * 4,
                                   "total": rows * cols * 4}
        assert rec.calls == 1
        # Partial over 'model' -> Replicate: an all-reduce of the local
        # tensor
        p = DTensor.from_local(torch.empty(rows, cols), mesh,
                               [Replicate(), Partial()], run_check=False)
        with port.CostRecorder() as rec:
            p.redistribute(mesh, [Replicate(), Replicate()])
        assert rec.collectives == {"all-reduce": rows * cols * 4,
                                   "total": rows * cols * 4}
        # Partial over 'model' -> Shard(0): a reduce-scatter, its result
        # this rank's 1/n of the rows
        with port.CostRecorder() as rec:
            p.redistribute(mesh, [Replicate(), Shard(0)])
        assert rec.collectives == {"reduce-scatter": rows * cols * 4 / n,
                                   "total": rows * cols * 4 / n}


def test_recorder_counts_c10d_collectives():
    """The MoE exchange calls ``torch.distributed`` directly: c10d ops."""
    import torch.distributed as dist

    with _fake_world((2, 2), ("data", "model"), "cpu") as mesh:
        group = mesh.get_group("model")
        x = torch.empty(8, 16)
        out = torch.empty_like(x)
        with port.CostRecorder() as rec:
            dist.all_to_all_single(out, x, group=group)
            dist.all_reduce(x, group=group)
        assert rec.collectives == {"all-to-all": 8 * 16 * 4,
                                   "all-reduce": 8 * 16 * 4,
                                   "total": 2 * 8 * 16 * 4}


def test_flops_are_per_device():
    """(64, 128) @ (128, 256) on a (2, 2) mesh, [Shard(0), Replicate()] x
    [Replicate(), Shard(1)]: rank 0 multiplies (32, 128) by (128, 128),
    1,048,576 FLOPs, not the global product's 4,194,304."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode

    with _fake_world((2, 2), ("data", "model"), "cpu") as mesh:
        a = DTensor.from_local(torch.empty(32, 128), mesh,
                               [Shard(0), Replicate()], run_check=False)
        b = DTensor.from_local(torch.empty(128, 128), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        with port.CostRecorder() as rec:
            a @ b
        with FlopCounterMode(display=False) as global_count:
            a @ b
    assert rec.flops == 1_048_576 == 2 * 32 * 128 * 128
    assert global_count.get_total_flops() == 4_194_304


def test_bytes_accessed_view_and_matmul():
    x = torch.randn(4, 8)
    y = torch.randn(8, 16)
    with port.CostRecorder() as rec:
        x.view(8, 4)
        x.t()
    assert rec.bytes_accessed == 0 and rec.flops == 0
    with port.CostRecorder() as rec:
        x @ y
    assert rec.bytes_accessed == (4 * 8 + 8 * 16 + 4 * 16) * 4
    assert rec.flops == 2 * 4 * 8 * 16
