"""Core of the port: the flexibility formalism (TOPS axes + the fifth
representation axis R), the analytical cost model on torch tensors, the
GAMMA-style constrained GA mapper with its batched device engine, and the
genome -> Hopper kernel bridge.
"""
from .classes import (ALL_CLASSES, ALL_CLASSES_5, PRIOR_WORK, classify,
                      describe)
from .cost_model import (CostResult, evaluate_mapping, evaluate_population,
                         evaluate_rows, lower_bound_cycles)
from .engine import (EngineRow, RowResult, ga_params_key, row_cache_key,
                     run_batched_ga, warmup_engine)
from .kernel_bridge import (KernelConfig, KernelWorkload, MeasuredRunner,
                            TuneResult, bridge_tile_feasible, config_legal,
                            lower_genome, lower_mapping, matmul_workload,
                            parity_check, predicted_runtime,
                            rank_correlation_study, spearman, tune_kernel)
from .mapper import (GAConfig, MapperResult, ModelResult,
                     assemble_model_result, plan_model_rows,
                     raw_tile_feasibility, request_rows, search,
                     search_model, search_model_batched)
from .mapspace import Mapping, MapSpace, mapspace_for, workload_space_size
from .precision import (FULL_BITS, PART_BITS, bytes_of, element_scale,
                        mac_scale, native_bits)
from .result_cache import ResultCache
from .spec import (FULLFLEX, INFLEX, PARTFLEX, FlexSpec, HWConfig, OrderSpec,
                   ParallelSpec, RepresentationSpec, ShapeSpec, TileSpec,
                   inflex_baseline, make_variant)
from .workloads import MODEL_ZOO, Layer, conv, dwconv, gemm, get_model

__all__ = [
    "ALL_CLASSES", "ALL_CLASSES_5", "PRIOR_WORK", "classify", "describe",
    "CostResult", "evaluate_mapping", "evaluate_population",
    "evaluate_rows", "lower_bound_cycles", "EngineRow", "RowResult",
    "ga_params_key", "row_cache_key", "run_batched_ga", "warmup_engine",
    "KernelConfig", "KernelWorkload", "MeasuredRunner", "TuneResult",
    "bridge_tile_feasible", "config_legal", "lower_genome", "lower_mapping",
    "matmul_workload", "parity_check", "predicted_runtime",
    "rank_correlation_study", "spearman", "tune_kernel",
    "GAConfig", "MapperResult", "ModelResult", "assemble_model_result",
    "plan_model_rows", "raw_tile_feasibility", "request_rows", "search",
    "search_model", "search_model_batched",
    "Mapping", "MapSpace", "mapspace_for", "workload_space_size",
    "FULL_BITS", "PART_BITS", "bytes_of", "element_scale", "mac_scale",
    "native_bits", "ResultCache",
    "FULLFLEX", "INFLEX", "PARTFLEX", "FlexSpec", "HWConfig", "OrderSpec",
    "ParallelSpec", "RepresentationSpec", "ShapeSpec", "TileSpec",
    "inflex_baseline", "make_variant", "MODEL_ZOO", "Layer", "conv",
    "dwconv", "gemm", "get_model",
]
