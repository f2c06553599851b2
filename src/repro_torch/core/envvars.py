"""Registry of every ``REPRO_*`` environment variable the PyTorch port reads.

The port keeps its own registry (the JAX package's is frozen and lists the
knobs of its benches; the port's benches and its BENCH writer take their
mode, path, device pool and client count as arguments instead).
``get_env`` is the accessor every call site uses; an unregistered name
raises, so a mistyped knob fails at the read site.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

__all__ = ["EnvVar", "REGISTRY", "get_env", "render_table"]


@dataclasses.dataclass(frozen=True)
class EnvVar:
    name: str
    kind: str                    # "choice" | "flag" | "int" | "path" | "spec"
    default: str                 # behavior when unset, as rendered in docs
    description: str
    consumers: Tuple[str, ...]   # modules that read it


REGISTRY: Tuple[EnvVar, ...] = (
    EnvVar(
        "REPRO_NO_KERNELS", "flag", "off",
        "Kernel-bridge autotuning falls back to the modeled objective "
        "instead of timing the hand-written kernels.",
        ("repro_torch.core.kernel_bridge",)),
    EnvVar(
        "REPRO_FLEXION_BACKEND", "choice", "by device",
        "Backend of the flexion T-axis predicates: `numpy` (float64 on the "
        "host) or `torch` (float32 on the caller's device).  Unset: torch "
        "on a CUDA device, numpy on the CPU.",
        ("repro_torch.core.flexion_batched",)),
    EnvVar(
        "REPRO_DEVICES", "spec: count / 'all' / i,j,...", "unset",
        "Device pool for campaign chunks when neither the GAConfig nor the "
        "call's `devices` argument names one (see "
        "repro_torch.dist.pool.parse_device_spec): CUDA ordinals on a CUDA "
        "call, the one CPU device on a CPU call.  Unset: every "
        "chunk runs on the call's own device.  The BENCH writer refuses "
        "it (its passes take their pool from `--devices`).",
        ("repro_torch.core.device_pool", "repro_torch.bench.run")),
    EnvVar(
        "REPRO_DRYRUN_JSONL", "path", "results/dryrun.jsonl",
        "The dry-run records the roofline bench reads (and, when there are "
        "none, appends one gemma-2b x train_4k cell to).",
        ("repro_torch.bench.roofline",)),
)

_BY_NAME = {v.name: v for v in REGISTRY}


def get_env(name: str, default: Optional[str] = None) -> Optional[str]:
    """The one accessor for ``REPRO_*`` knobs.  Unregistered names raise
    KeyError so a typo'd knob fails loudly at the read site instead of
    silently falling back to the default forever."""
    if name not in _BY_NAME:
        raise KeyError(
            f"{name!r} is not in repro_torch.core.envvars.REGISTRY — "
            f"register it before reading")
    return os.environ.get(name, default)


def render_table() -> str:
    """docs/envvars_torch.md, generated.  One row per registered variable."""
    lines = [
        "# Environment variables of the PyTorch port",
        "",
        "Generated from `repro_torch.core.envvars.REGISTRY` — do not edit "
        "by hand.",
        "Regenerate: `PYTHONPATH=src python -m repro_torch.core.envvars > "
        "docs/envvars_torch.md`.",
        "The port's REP006 lint rule (docs/analysis_torch.md) fails the "
        "build if a `REPRO_*` read exists without a registry entry, and "
        "tests/test_torch_analysis.py fails if this file drifts from the "
        "registry.",
        "",
        "| Variable | Type | Default | Consumers | Description |",
        "|---|---|---|---|---|",
    ]
    for v in REGISTRY:
        consumers = ", ".join(f"`{c}`" for c in v.consumers)
        lines.append(f"| `{v.name}` | {v.kind} | {v.default} | "
                     f"{consumers} | {v.description} |")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    print(render_table(), end="")
