"""Flexibility-aware Design-Space Exploration (paper Fig 6).

Toolflow: (DNN model description, baseline HW resources, HW flexibility
specification) -> selects the map space -> internal MSE (GA) -> best design
point + HW performance (runtime, energy, area, power).

Also implements the Sec 7 "future-proofing" workflow:
  1. design InFlex-0000-<model>-Opt: one TOPS(R) config optimized for a
     model (the representation axis is frozen to the searched bit-width),
  2. derive flexible variants that keep the frozen config on inflexible axes
     but open chosen axes (FullFlex/PartFlex-xxxxx-<model>-Opt; 4-char class
     strings keep the paper's T/O/P/S sweep with R pinned),
  3. replay all variants on "future" models.

Every entry point takes ``device`` (``None``: the CUDA card).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import area_model
from .flexion import FlexionReport
from .flexion_batched import flexion_campaign, model_flexion_campaign
from .mapper import (GAConfig, ModelResult, evaluate_fixed_genome,
                     evaluate_fixed_genome_many, search_campaign,
                     search_fixed_config, search_fixed_configs,
                     search_model, search_specs_batched)
from .mapspace import MapSpace
from .spec import (FULLFLEX, INFLEX, PARTFLEX, FlexSpec, HWConfig, OrderSpec,
                   ParallelSpec, RepresentationSpec, ShapeSpec, TileSpec,
                   perm_to_order_str)
from .workloads import DIMS, Layer, get_model


@dataclasses.dataclass
class DSEResult:
    spec_name: str
    class_str: str
    runtime: float
    energy: float
    edp: float
    area: float
    power: float
    flexion: Optional[FlexionReport]
    model_result: ModelResult

    def row(self) -> Dict[str, float]:
        return dict(name=self.spec_name, cls=self.class_str,
                    runtime=self.runtime, energy=self.energy, edp=self.edp,
                    area=self.area, power=self.power,
                    hf=self.flexion.hf if self.flexion else float("nan"),
                    wf=self.flexion.wf if self.flexion else float("nan"))


def run_dse(layers: Sequence[Layer], candidates: Sequence[FlexSpec],
            cfg: Optional[GAConfig] = None, with_flexion: bool = False,
            flexion_samples: int = 20_000, device=None) -> List[DSEResult]:
    """Evaluate candidate accelerators; every DSE step includes a full MSE
    per benchmark layer (paper Sec 2.4).

    With the batched engine, candidates sharing an HWConfig are searched as
    one engine row set (rows = specs x unique layers); results are
    bit-identical to per-spec ``search_model`` calls.  ``with_flexion``
    likewise estimates every candidate's flexion through one
    ``model_flexion_campaign`` batch."""
    cfg = cfg or GAConfig()
    candidates = list(candidates)
    if not candidates:
        return []      # an empty candidate set is a valid (empty) DSE
    if (cfg.engine == "batched" and len(candidates) > 1
            and all(s.hw == candidates[0].hw for s in candidates)):
        mres_list = search_specs_batched(layers, candidates, cfg,
                                         device=device)
    else:
        mres_list = [search_model(layers, spec, cfg, device=device)
                     for spec in candidates]
    if with_flexion:
        flex_list = model_flexion_campaign(
            [(spec, layers) for spec in candidates], flexion_samples,
            device=device, devices=cfg.devices)
    else:
        flex_list = [None] * len(candidates)
    out = []
    for spec, mres, flexion in zip(candidates, mres_list, flex_list):
        ar = area_model.area_of(spec)
        out.append(DSEResult(
            spec_name=spec.name, class_str=spec.class_str(),
            runtime=mres.runtime, energy=mres.energy, edp=mres.edp,
            area=ar.total_area, power=ar.total_power, flexion=flexion,
            model_result=mres))
    return out


# --------------------------------------------------------------------------
# Sec 7: future-proofing workflow
# --------------------------------------------------------------------------

def design_fixed_accelerator(model_name: str, hw: Optional[HWConfig] = None,
                             cfg: Optional[GAConfig] = None, device=None
                             ) -> Tuple[FlexSpec, np.ndarray, ModelResult]:
    """InFlex-0000-<model>-Opt: harden the best single mapping into silicon."""
    hw = hw or HWConfig()
    layers = get_model(model_name)
    # search over the full space for the best *single* config
    probe_spec = FlexSpec(name=f"probe-{model_name}", hw=hw)
    genome, res = search_fixed_config(layers, probe_spec, cfg, device)
    spec = freeze_spec_from_genome(probe_spec, layers, genome,
                                   name=f"InFlex0000-{model_name}-Opt")
    return spec, genome, res


def freeze_spec_from_genome(probe_spec: FlexSpec, layers: Sequence[Layer],
                            genome: np.ndarray, name: str) -> FlexSpec:
    """Turn a search genome into an InFlex-00000 spec (fixed T/O/P/S/R)."""
    probe = Layer("probe", tuple(int(v) for v in
                                 np.max([l.dims for l in layers], axis=0)))
    space = MapSpace(probe, probe_spec)
    m = space.decode(space.clip(genome[None, :])[0])
    return FlexSpec(
        name=name, hw=probe_spec.hw,
        tile=TileSpec(flex=INFLEX, fixed_tile=m.tiles),
        order=OrderSpec(flex=INFLEX, fixed_order=perm_to_order_str(m.order)),
        parallel=ParallelSpec(flex=INFLEX,
                              fixed_pair=(DIMS[m.parallel[0]],
                                          DIMS[m.parallel[1]])),
        shape=ShapeSpec(flex=INFLEX, fixed_shape=m.shape),
        representation=RepresentationSpec(flex=INFLEX,
                                          fixed_bits=int(m.repr_bits)),
    )


def open_axes(frozen: FlexSpec, class_str: str, level: str = FULLFLEX,
              name: Optional[str] = None) -> FlexSpec:
    """Open the axes marked '1' in class_str on an otherwise frozen design
    (FullFlex-xxxx-<model>-Opt in Fig 13).  4-char class strings keep the
    paper's T/O/P/S sweep (R stays pinned); 5-char strings also open the
    representation axis."""
    if len(class_str) not in (4, 5):
        raise ValueError(f"class string {class_str!r} must have 4 or 5 "
                         f"characters")
    t, o, p, s, r = class_str.ljust(5, "0")
    prefix = {PARTFLEX: "PartFlex", FULLFLEX: "FullFlex"}[level]
    return FlexSpec(
        name=name or f"{prefix}{class_str}-" + frozen.name.split("-", 1)[-1],
        hw=frozen.hw,
        tile=dataclasses.replace(frozen.tile,
                                 flex=level if t == "1" else INFLEX),
        order=dataclasses.replace(frozen.order,
                                  flex=level if o == "1" else INFLEX),
        parallel=dataclasses.replace(frozen.parallel,
                                     flex=level if p == "1" else INFLEX),
        shape=dataclasses.replace(frozen.shape,
                                  flex=level if s == "1" else INFLEX),
        representation=dataclasses.replace(
            frozen.representation, flex=level if r == "1" else INFLEX),
    )


def future_proofing_study(base_model: str = "alexnet",
                          future_models: Sequence[str] = (
                              "alexnet", "mnasnet", "resnet50", "mobilenetv2",
                              "bert", "dlrm", "ncf"),
                          class_strs: Sequence[str] = (
                              "1000", "0100", "0010", "0001", "0011", "0101",
                              "1001", "0110", "1010", "1100", "1110", "1011",
                              "0111", "1101", "1111"),
                          hw: Optional[HWConfig] = None,
                          cfg: Optional[GAConfig] = None,
                          include_partflex_1111: bool = True,
                          campaign: bool = False,
                          timings: Optional[Dict[str, float]] = None,
                          flexion: Optional[Dict[str, float]] = None,
                          wflexion: Optional[Dict[str, float]] = None,
                          flexion_samples: int = 20_000, device=None
                          ) -> Dict[str, Dict[str, float]]:
    """Fig 13: rows = accelerator variants, cols = models, values = runtime
    normalized to InFlex-0000-<base>-Opt on that model.

    ``campaign=True`` batches each of the three phases across *every* model
    instead of looping model-by-model: one ``search_fixed_configs`` call
    designs all InFlex-0000-X-Opt accelerators, one
    ``evaluate_fixed_genome_many`` pass replays the frozen design
    everywhere, and one ``search_campaign`` row set sweeps all
    (model, variant) MSEs.  The table is bit-identical either way.

    ``timings`` accumulates per-phase wall-clock seconds under
    ``design_fixed`` / ``replay_frozen`` / ``flex_sweep`` (and ``flexion``
    when requested).  ``flexion`` / ``wflexion`` (optional dicts) are
    filled with the H-F / W-F column ``{row_name: value}``, estimated in
    one campaign batch each (W-F against the union of every future
    model's layers)."""
    cfg = cfg or GAConfig()
    t_acc: Dict[str, float] = timings if timings is not None else {}

    def tick(phase: str, t0: float) -> None:
        t_acc[phase] = round(t_acc.get(phase, 0.0) + time.time() - t0, 6)

    designs: Dict[str, Tuple[np.ndarray, ModelResult]] = {}
    t0 = time.time()
    if campaign:
        hw_ = hw or HWConfig()
        names = list(dict.fromkeys([base_model, *future_models]))
        designs = dict(zip(names, search_fixed_configs(
            [(get_model(m), FlexSpec(name=f"probe-{m}", hw=hw_))
             for m in names], cfg, device)))
        genome, _ = designs[base_model]
        frozen = freeze_spec_from_genome(
            FlexSpec(name=f"probe-{base_model}", hw=hw_),
            get_model(base_model), genome,
            name=f"InFlex0000-{base_model}-Opt")
    else:
        frozen, genome, _ = design_fixed_accelerator(base_model, hw, cfg,
                                                     device)
    tick("design_fixed", t0)

    table: Dict[str, Dict[str, float]] = {}
    baseline_rt: Dict[str, float] = {}

    # row 1: the frozen 2014 accelerator on every model
    t0 = time.time()
    if campaign:
        replays = evaluate_fixed_genome_many(
            [(get_model(m), frozen, genome) for m in future_models], device,
            cfg.devices)
        row = {m: res.runtime for m, res in zip(future_models, replays)}
    else:
        row = {m: evaluate_fixed_genome(get_model(m), frozen, genome,
                                        device, cfg.devices).runtime
               for m in future_models}
    baseline_rt.update(row)
    table[f"InFlex0000-{base_model}-Opt"] = row
    tick("replay_frozen", t0)

    # row 2: a fixed accelerator re-optimized per future model (already
    # designed above in campaign mode)
    t0 = time.time()
    row = {}
    for m in future_models:
        if m == base_model:
            row[m] = baseline_rt[m]
        elif campaign:
            row[m] = designs[m][1].runtime
        else:
            _, _, res = design_fixed_accelerator(m, hw, cfg, device)
            row[m] = res.runtime
    table["InFlex0000-X-Opt"] = row
    tick("design_fixed", t0)

    # flexible variants of the 2014 design
    flex_specs = [open_axes(frozen, cs, FULLFLEX) for cs in class_strs]
    if include_partflex_1111:
        flex_specs.append(open_axes(frozen, "1111", PARTFLEX))

    if flexion is not None or wflexion is not None:
        t0 = time.time()
        fx_specs = [frozen, *flex_specs]
        if flexion is not None:
            reports = flexion_campaign([(s, None, 0) for s in fx_specs],
                                       mc_samples=flexion_samples, seed=0,
                                       device=device, devices=cfg.devices)
            flexion.update({s.name: r.hf for s, r in zip(fx_specs, reports)})
            flexion["InFlex0000-X-Opt"] = flexion[frozen.name]
        if wflexion is not None:
            future_layers = [l for m in future_models for l in get_model(m)]
            wreports = model_flexion_campaign(
                [(s, future_layers) for s in fx_specs], flexion_samples,
                device=device, devices=cfg.devices)
            wflexion.update(
                {s.name: r.wf for s, r in zip(fx_specs, wreports)})
            wflexion["InFlex0000-X-Opt"] = wflexion[frozen.name]
        tick("flexion", t0)
    for spec in flex_specs:
        table[spec.name] = {}
    t0 = time.time()
    if campaign:
        all_res = iter(search_campaign(
            [(get_model(m), spec) for m in future_models
             for spec in flex_specs], cfg, device=device))
        for m in future_models:
            for spec in flex_specs:
                table[spec.name][m] = next(all_res).runtime
    else:
        for m in future_models:
            layers = get_model(m)
            if cfg.engine == "batched":
                results = search_specs_batched(layers, flex_specs, cfg,
                                               device=device)
            else:
                results = [search_model(layers, spec, cfg, device=device)
                           for spec in flex_specs]
            for spec, mres in zip(flex_specs, results):
                table[spec.name][m] = mres.runtime
    tick("flex_sweep", t0)

    # normalize by the frozen baseline per column
    base_row = table[f"InFlex0000-{base_model}-Opt"]
    return {r: {m: v / base_row[m] for m, v in cols.items()}
            for r, cols in table.items()}


def geomean_speedup(norm_table: Dict[str, Dict[str, float]],
                    flex_row: str, models: Optional[Sequence[str]] = None
                    ) -> float:
    """Geomean of 1/normalized-runtime for a flexible row (paper: 11.8x)."""
    row = norm_table[flex_row]
    models = models or list(row.keys())
    vals = np.asarray([row[m] for m in models], np.float64)
    return float(np.exp(np.mean(np.log(1.0 / np.maximum(vals, 1e-12)))))
