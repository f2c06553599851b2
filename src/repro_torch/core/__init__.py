"""Core of the port: the flexibility formalism (TOPS axes + the fifth
representation axis R, flexion metrics), the analytical cost model on torch
tensors, the GAMMA-style constrained GA mapper with its batched device
engine, the flexibility-aware DSE toolflow, and the genome -> Hopper kernel
bridge.
"""
from .area_model import AreaReport, area_of
from .classes import (ALL_CLASSES, ALL_CLASSES_5, PRIOR_WORK, classify,
                      describe)
from .cost_model import (CostResult, evaluate_mapping, evaluate_population,
                         evaluate_rows, lower_bound_cycles)
from .dse import (DSEResult, design_fixed_accelerator,
                  freeze_spec_from_genome, future_proofing_study,
                  geomean_speedup, open_axes, run_dse)
from .engine import (EngineRow, RowResult, ga_params_key, row_cache_key,
                     run_batched_ga, warmup_engine)
from .flexion import FlexionReport, compute_flexion, model_flexion
from .flexion_batched import (clear_flexion_reference_cache,
                              flexion_cache_stats, flexion_campaign,
                              model_flexion_campaign)
from .kernel_bridge import (KernelConfig, KernelWorkload, MeasuredRunner,
                            TuneResult, attention_workload,
                            bridge_tile_feasible, config_legal,
                            lower_genome, lower_mapping, mamba_workload,
                            matmul_workload, parity_check,
                            predicted_runtime, rank_correlation_study,
                            spearman, tune_kernel)
from .mapper import (GAConfig, MapperResult, ModelResult,
                     assemble_model_result, evaluate_fixed_genome,
                     evaluate_fixed_genome_many, plan_model_rows,
                     raw_tile_feasibility, request_rows, search,
                     search_campaign, search_fixed_config,
                     search_fixed_configs, search_model,
                     search_model_batched, search_specs_batched)
from .mapspace import Mapping, MapSpace, mapspace_for, workload_space_size
from .precision import (FULL_BITS, PART_BITS, bytes_of, element_scale,
                        mac_scale, native_bits)
from .result_cache import ResultCache
from .spec import (FULLFLEX, INFLEX, PARTFLEX, FlexSpec, HWConfig, OrderSpec,
                   ParallelSpec, RepresentationSpec, ShapeSpec, TileSpec,
                   inflex_baseline, make_variant)
from .workloads import MODEL_ZOO, Layer, conv, dwconv, gemm, get_model

__all__ = [
    "AreaReport", "area_of",
    "ALL_CLASSES", "ALL_CLASSES_5", "PRIOR_WORK", "classify", "describe",
    "CostResult", "evaluate_mapping", "evaluate_population",
    "evaluate_rows", "lower_bound_cycles",
    "DSEResult", "design_fixed_accelerator", "freeze_spec_from_genome",
    "future_proofing_study", "geomean_speedup", "open_axes", "run_dse",
    "EngineRow", "RowResult", "ga_params_key", "row_cache_key",
    "run_batched_ga", "warmup_engine",
    "FlexionReport", "compute_flexion", "model_flexion",
    "clear_flexion_reference_cache", "flexion_cache_stats",
    "flexion_campaign", "model_flexion_campaign",
    "KernelConfig", "KernelWorkload", "MeasuredRunner", "TuneResult",
    "attention_workload", "bridge_tile_feasible", "config_legal",
    "lower_genome", "lower_mapping", "mamba_workload", "matmul_workload",
    "parity_check", "predicted_runtime", "rank_correlation_study",
    "spearman", "tune_kernel",
    "GAConfig", "MapperResult", "ModelResult", "assemble_model_result",
    "evaluate_fixed_genome", "evaluate_fixed_genome_many",
    "plan_model_rows", "raw_tile_feasibility", "request_rows", "search",
    "search_campaign", "search_fixed_config", "search_fixed_configs",
    "search_model", "search_model_batched", "search_specs_batched",
    "Mapping", "MapSpace", "mapspace_for", "workload_space_size",
    "FULL_BITS", "PART_BITS", "bytes_of", "element_scale", "mac_scale",
    "native_bits", "ResultCache",
    "FULLFLEX", "INFLEX", "PARTFLEX", "FlexSpec", "HWConfig", "OrderSpec",
    "ParallelSpec", "RepresentationSpec", "ShapeSpec", "TileSpec",
    "inflex_baseline", "make_variant", "MODEL_ZOO", "Layer", "conv",
    "dwconv", "gemm", "get_model",
]
