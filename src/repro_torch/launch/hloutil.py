"""Cost helpers for the dry-run, the counterpart of
``repro/launch/hloutil.py``.

The hardware constants are an NVIDIA H100 SXM5 80 GB's data-sheet values
for a card at its 700 W limit, not measurements: 989 TFLOP/s bf16 dense,
3.35 TB/s HBM3, and NVLink 4 as 18 links of 25 GB/s a direction
(450 GB/s).  The collective term prices every collective at NVLink's rate.
A 16x16 mesh spans 32 nodes of 8 cards, so a collective that crosses
InfiniBand is priced below its real cost by this term; it is kept as the
reference computes it, with no second term.

Two sources of collective bytes:

  ``collective_bytes(hlo_text)``  the reference's parser of compiled HLO
                                  text, kept as a copy (a pure string
                                  function);
  ``CostRecorder``                the port's: a ``TorchDispatchMode`` that
                                  records every collective a sharded step
                                  issues (``_c10d_functional.*`` from
                                  DTensor redistributions, ``c10d.*`` from
                                  the MoE all-to-all), by the same kind
                                  names and the same convention: result
                                  bytes a device.

``CostRecorder`` also counts the step's FLOPs and bytes accessed on each
op's *local* tensors (a ``DTensor`` op is passed on to its local ops), so
both are per device.
"""
from __future__ import annotations

import contextlib
import functools
import re
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12          # bf16 dense FLOP/s per card (H100 SXM5)
HBM_BW = 3.35e12             # bytes/s per card
ICI_BW = 25e9                # bytes/s per NVLink 4 link, one direction
ICI_LINKS = 18               # NVLink 4 links per card

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8": 1,
                "s64": 8, "s32": 4, "u64": 8, "u32": 4, "s16": 2, "u16": 2,
                "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16}

_COLL_RE = re.compile(
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?(?:\.\d+)?\s*\(")
_SHAPE_RE = re.compile(r"([a-z]+[0-9]*)\[([0-9,]*)\]")


def _line_operand_bytes(line: str) -> float:
    """Sum every tensor shape printed on the instruction line (result and
    any annotated operands).  HLO text prints operands without shapes, so
    the RESULT size is the reliable proxy: all-gather result = bytes
    received/device; all-reduce result = bytes reduced; reduce-scatter /
    all-to-all results = bytes kept (a mild undercount we accept
    consistently across baseline and optimized variants)."""
    try:
        rhs = line.split("=", 1)[1]
    except IndexError:
        rhs = line
    total = 0.0
    for dt, dims in _SHAPE_RE.findall(rhs):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Per-device bytes moved by collectives (post-SPMD compiled HLO)."""
    out: Dict[str, float] = {}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m or "=" not in line:
            continue
        kind = m.group(1)
        out[kind] = out.get(kind, 0.0) + _line_operand_bytes(line)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def roofline_terms(flops: float, hbm_bytes: float,
                   coll_bytes: float) -> Dict[str, float]:
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm_bytes / HBM_BW
    collective_s = coll_bytes / (ICI_BW * ICI_LINKS)
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])[0]
    total = max(compute_s, memory_s, collective_s)
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "dominant": dominant,
            "bound_s": total,
            "roofline_fraction": compute_s / total if total else 0.0}


# --------------------------------------------------------------------------
# the port's counts: one dispatch mode over a sharded step
# --------------------------------------------------------------------------

# collective op name (the overload packet's) -> the reference's kind name
_COLLECTIVE_KINDS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "collective-permute",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.alltoall_": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.broadcast_": "collective-permute",
}

# metadata queries, which FlopCounterMode passes over as well
_QUERIES = {getattr(torch.ops.aten, n).default for n in (
    "sym_is_contiguous", "is_contiguous", "is_strides_like_format",
    "is_non_overlapping_and_dense", "size", "sym_size", "stride",
    "sym_stride", "storage_offset", "sym_storage_offset", "numel",
    "sym_numel", "dim")} | {torch.ops.aten.is_contiguous.memory_format,
                            torch.ops.prim.layout.default,
                            torch.ops.prim.device.default}

# allocations that write nothing
_NO_TRAFFIC = {torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.empty_like.default}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


class CostRecorder(TorchDispatchMode):
    """Counts, per device, what the ops run in its context do:

      flops          the FLOPs of ``torch.utils.flop_counter``'s registry
                     (matmuls, attention, convolutions), evaluated on the
                     local tensors, decomposing what the registry lacks as
                     ``FlopCounterMode`` does;
      bytes_accessed the operand and result bytes of every op but views
                     (which move none) and bare allocations: the eager
                     port's unfused traffic, not a fused program's;
      collectives    result bytes by the reference's kind names, with a
                     ``"total"``; ``calls`` counts the collectives.

    A ``DTensor`` op is handed on (``NotImplemented``), so its sharding
    propagation is not counted and its local ops, redistributions
    included, are.  Run it inside ``quiet_sharding_propagation()`` so the
    global-shape ops DTensor runs to infer output metadata are not seen
    either."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.coll = defaultdict(float)
        self.calls = 0

    @property
    def collectives(self) -> Dict[str, float]:
        out = dict(self.coll)
        out["total"] = sum(out.values())
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        if func in _QUERIES:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in self.registry:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        name = str(packet)
        kind = _COLLECTIVE_KINDS.get(name)
        if kind is not None:
            self.calls += 1
            # functional collectives return their result; c10d's write it
            # into their first argument
            self.coll[kind] += _nbytes(out if name.startswith("_c10d")
                                       else args[0])
        if not func.is_view and func not in _NO_TRAFFIC:
            self.bytes_accessed += _nbytes(args) + _nbytes(kwargs) \
                + _nbytes(out)
        return out


@contextlib.contextmanager
def quiet_sharding_propagation():
    """DTensor infers an op's output metadata by running the op once on
    global-shape fake tensors (cached by the op's schema), and works out
    a strided shard's local size with host tensors.  In this context both
    run with every dispatch mode switched off: no counter or memory
    tracker sees tensors no device holds, and the host arithmetic stays
    real under a fake tensor mode."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils._python_dispatch import _disable_current_modes

    def quiet(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with _disable_current_modes():
                return fn(*args, **kwargs)
        return run

    patched = []
    for owner, name in ((ShardingPropagator,
                         "_propagate_tensor_meta_non_cached"),
                        (_StridedShard, "local_shard_size_and_offset"),
                        (_StridedShard, "_local_shard_size")):
        orig = owner.__dict__.get(name)
        if orig is None:
            continue
        wrapped = (staticmethod(quiet(orig.__func__))
                   if isinstance(orig, staticmethod) else quiet(orig))
        setattr(owner, name, wrapped)
        patched.append((owner, name, orig))
    try:
        yield
    finally:
        for owner, name, orig in patched:
            setattr(owner, name, orig)
