"""BEYOND-PAPER: the TOPS formalism applied to the TPU pod itself (a copy of
``repro/core/tops_bridge.py``: host arithmetic, no device).

The paper's four flexibility axes map 1:1 onto distributed-training knobs:

  S (array shape)    -> logical mesh factorization (dp, tp) of the chips
  P (parallelism)    -> which tensor dims shard where: FSDP on/off,
                        sequence-parallel residual stream, EP for MoE
  T (tile size)      -> microbatch count (gradient accumulation)
  O (loop order)     -> remat on/off (recompute vs store — the temporal
                        ordering of the backward pass)
  R (representation) -> training numerics; pinned to bf16 here (InFlex-R:
                        the pod is deployed with one dtype), routed through
                        ``precision.BF16_BITS`` so the width assumption
                        lives in one place

An *inflexible* deployment hard-codes one point (the production default);
a *flexible* one lets the mapper pick per-(arch x shape).  The map-space is
small enough to enumerate exactly, so the DSE here is exhaustive rather than
GA — same formalism, |A_X| listed below per axis.  Costs come from the same
chip-level roofline terms the dry-run measures (197 TF/s, 819 GB/s HBM,
~50 GB/s/link ICI, 16 GB HBM per chip), so winners are directly checkable
against the reference's `repro.launch.dryrun` artifacts.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

from .precision import BF16_BITS, bytes_of

# The datasheet figures of the TPU pod chip the reference models (bf16
# peak, HBM rate, ICI link rate and links, HBM size), kept so that the
# port ranks the pod map space exactly as the reference does.  They are not
# the figures of the card the port runs on.
PEAK_FLOPS = 197e12
HBM_BW = 819e9
ICI_BW = 50e9
ICI_LINKS = 4
HBM_BYTES = 16e9
BF16 = bytes_of(BF16_BITS)      # R axis: training traffic is bf16 end-to-end


@dataclasses.dataclass(frozen=True)
class PodMapping:
    """One point in the pod-level map space (the paper's 'Mapping')."""
    dp: int                 # S axis: data-parallel degree
    tp: int                 # S axis: model-parallel degree
    fsdp: bool              # P axis: ZeRO-3 param sharding over dp
    seq_acts: bool          # P axis: sequence-parallel residual stream
    n_micro: int            # T axis: gradient-accumulation microbatches
    remat: bool             # O axis: recompute vs store activations


@dataclasses.dataclass
class PodCost:
    compute_s: float
    memory_s: float
    collective_s: float
    hbm_used: float
    fits: bool

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def dominant(self) -> str:
        return max(("compute", self.compute_s), ("memory", self.memory_s),
                   ("collective", self.collective_s),
                   key=lambda kv: kv[1])[0]


def enumerate_mappings(n_chips: int, flexible: bool = True
                       ) -> List[PodMapping]:
    """A_X: the production default only (InFlex) or the full space."""
    if not flexible:
        return [PodMapping(dp=16, tp=n_chips // 16, fsdp=False,
                           seq_acts=False, n_micro=1, remat=True)]
    meshes = [(d, n_chips // d) for d in (1, 2, 4, 8, 16, 32, 64, 128, 256)
              if d <= n_chips and n_chips % d == 0]
    out = []
    for (dp, tp), fsdp, seq, mic, rem in itertools.product(
            meshes, (False, True), (False, True), (1, 2, 4, 8),
            (False, True)):
        out.append(PodMapping(dp, tp, fsdp, seq, mic, rem))
    return out


def cost_mapping(cfg, shape, m: PodMapping, n_chips: int) -> PodCost:
    """Chip-level roofline of one training step under mapping `m`."""
    from ..configs.shapes import model_flops_per_step

    tokens = shape.global_batch * shape.seq_len
    if shape.global_batch % m.dp or shape.seq_len % (m.tp if m.seq_acts
                                                     else 1):
        return PodCost(1e9, 1e9, 1e9, float("inf"), False)
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    param_bytes = n_params * BF16
    tok_local = tokens / m.dp / (m.tp if m.seq_acts else 1)
    micro_tok = tok_local / m.n_micro

    # ---- compute: fwd+bwd (6ND) + remat recompute (+2ND) -------------------
    flops = model_flops_per_step(cfg, shape) / n_chips
    if m.remat:
        flops *= 8.0 / 6.0
    compute_s = flops / PEAK_FLOPS

    # ---- HBM traffic --------------------------------------------------------
    # params touched fwd+bwd+opt (3x) per microbatch when streamed via FSDP,
    # once per step otherwise; active-params only for MoE compute reads
    p_shard = n_chips if m.fsdp else m.tp
    param_traffic = 3.0 * param_bytes / p_shard * m.n_micro
    # activations: ~12 tensors of (tok, d) per layer level, x2 with remat read
    depth = max(cfg.n_layers, 1)
    act_traffic = (12 * depth * micro_tok * cfg.d_model * BF16
                   * (2.0 if m.remat else 1.0) * m.n_micro)
    memory_s = (param_traffic + act_traffic) / HBM_BW

    # ---- collectives ---------------------------------------------------------
    link_bw = ICI_BW * ICI_LINKS
    coll = 0.0
    # TP: 2 all-reduces (or RS+AG pairs) of activations per layer, fwd+bwd
    if m.tp > 1:
        coll += (4 * depth * tok_local * cfg.d_model * BF16
                 * (m.tp - 1) / m.tp * m.n_micro)
    # DP gradient reduction (ring RS+AG)
    if m.dp > 1:
        coll += 2 * param_bytes / max(m.tp, 1) * (m.dp - 1) / m.dp
    # FSDP param all-gather fwd+bwd per microbatch
    if m.fsdp:
        coll += 2 * param_bytes / max(m.tp, 1) * m.n_micro
    # MoE all-to-all: 2 dispatch + 2 combine of the token stream per layer
    if cfg.n_experts:
        coll += 4 * depth * micro_tok * cfg.d_model * BF16 * m.n_micro
    collective_s = coll / link_bw

    # ---- memory footprint -----------------------------------------------------
    opt_bytes = (2 if n_params < 100e9 else 0.5) * n_params * 4  # adam/adafac
    state = (param_bytes + param_bytes + opt_bytes) / p_shard    # p + g + opt
    resid = depth * micro_tok * cfg.d_model * BF16 / (
        1 if m.seq_acts else 1)  # saved per-layer inputs (remat floor)
    act_peak = resid if m.remat else resid * 12
    hbm_used = state + act_peak
    return PodCost(compute_s, memory_s, collective_s, hbm_used,
                   hbm_used <= HBM_BYTES)


def autoshard(cfg, shape, n_chips: int = 256,
              flexible: bool = True) -> List[Tuple[PodMapping, PodCost]]:
    """Rank the pod-level map space by roofline bound (feasible first)."""
    scored = [(m, cost_mapping(cfg, shape, m, n_chips))
              for m in enumerate_mappings(n_chips, flexible)]
    return sorted(scored, key=lambda mc: (not mc[1].fits, mc[1].bound_s))


def autoshard_report(arch: str, shape_name: str, n_chips: int = 256,
                     top: int = 8, print_fn=print):
    from ..configs import SHAPES, get_config

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ranked = autoshard(cfg, shape, n_chips, flexible=True)
    default = autoshard(cfg, shape, n_chips, flexible=False)[0]

    print_fn(f"TOPS pod-level DSE: {arch} x {shape_name} on {n_chips} chips")
    print_fn(f"{'rank':>4s} {'mesh':>9s} {'fsdp':>5s} {'seqP':>5s} "
             f"{'micro':>5s} {'remat':>5s} {'bound_ms':>9s} {'dom':>10s} "
             f"{'hbm_GB':>7s} {'fits':>5s}")

    def row(i, m, c):
        print_fn(f"{i:>4} {m.dp:>4}x{m.tp:<4} {str(m.fsdp):>5s} "
                 f"{str(m.seq_acts):>5s} {m.n_micro:>5} {str(m.remat):>5s} "
                 f"{c.bound_s*1e3:>9.2f} {c.dominant:>10s} "
                 f"{c.hbm_used/1e9:>7.1f} {str(c.fits):>5s}")

    for i, (m, c) in enumerate(ranked[:top]):
        row(i + 1, m, c)
    dm, dc = default
    print_fn("-- production default (InFlex point) --")
    row(0, dm, dc)
    best = ranked[0]
    if dc.bound_s > 0 and best[1].fits:
        print_fn(f"flexible/inflexible bound ratio: "
                 f"{dc.bound_s / best[1].bound_s:.2f}x "
                 f"(the pod-level analogue of the paper's Fig 13)")
    return ranked, default
