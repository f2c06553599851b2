"""Flexion — the paper's flexibility fraction metric (Table 1, Fig 5).

  H-F (hardware-dependent)  = |A_X| / |C_X|
      how much of the class-X map space (everything legal under the HW
      resources) the concrete accelerator supports.  Workload-agnostic.

  W-F (workload-dependent)  = |A_X^w| / |W_X^w|
      how much of the workload's own map space the accelerator supports.

Per-axis fractions multiply (the axes are a cross product).  O/P/S axes are
counted exactly from their tables, and so is the fifth R axis (the operand
bit-width menu is a small exact table); the T axis intersects a product
space with buffer-capacity constraints, so it is estimated with Monte-Carlo
sampling.

The default H-F reference is *R-adaptive* (see
``flexion_batched._default_reference``): a pinned-R spec is measured against
a pinned-R FullFlex-T/O/P/S reference, an R-open spec against the
FullFlex-R domain.

The estimators here are thin single-row wrappers over the batched campaign
in ``flexion_batched.py`` (paired hard/soft samples, a memoized C_X
reference), with bit-identical results.  ``device`` picks the backend of
the T-axis predicates: float64 numpy on the host for a CPU device, float32
torch on a CUDA device (``REPRO_FLEXION_BACKEND`` forces one).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .spec import FlexSpec
from .workloads import Layer


@dataclasses.dataclass(frozen=True)
class FlexionReport:
    per_axis_hf: Dict[str, float]
    per_axis_wf: Dict[str, float]
    hf: float                      # product over axes
    wf: float
    mc_samples: int

    def __str__(self) -> str:
        ax_h = " ".join(f"{k}:{v:.3g}" for k, v in self.per_axis_hf.items())
        ax_w = " ".join(f"{k}:{v:.3g}" for k, v in self.per_axis_wf.items())
        return (f"H-F={self.hf:.4g} ({ax_h}) | W-F={self.wf:.4g} ({ax_w})")


def compute_flexion(spec: FlexSpec, layer: Optional[Layer] = None,
                    mc_samples: int = 200_000, seed: int = 0,
                    reference: Optional[FlexSpec] = None,
                    ref_seed: Optional[int] = None,
                    device=None, devices=None) -> FlexionReport:
    """Flexion of ``spec``.  ``reference`` defines C_X for the exact O/P/S/R
    axes (defaults to the FullFlex accelerator with the same HW resources,
    R-adaptive).  ``seed`` drives the workload (W-F) sample stream;
    ``ref_seed`` (default: ``seed``) selects the memoized C_X reference
    stream.  Single-row case of ``flexion_campaign``."""
    # imported here: flexion_batched imports FlexionReport from this module
    from .flexion_batched import flexion_campaign
    return flexion_campaign([(spec, layer, seed)], mc_samples=mc_samples,
                            seed=seed if ref_seed is None else ref_seed,
                            reference=reference, device=device,
                            devices=devices)[0]


def model_flexion(spec: FlexSpec, layers, mc_samples: int = 50_000,
                  seed: int = 0, device=None, devices=None) -> FlexionReport:
    """Average W-F across a model's layers; H-F is workload-agnostic and
    computed once from the shared reference cache.  Single-request case of
    ``model_flexion_campaign``."""
    if not layers:
        raise ValueError("model has no layers")
    from .flexion_batched import model_flexion_campaign
    return model_flexion_campaign([(spec, list(layers))], mc_samples, seed,
                                  device=device, devices=devices)[0]
