"""The per-layer readers' arithmetic, shared by the metric files of
``perfbench/metrics/`` (one file a metric, each naming its reader here).

A reader takes the driver's observations of one run and returns the
metric, or None where the run gives it nothing to read.
"""
from __future__ import annotations

from typing import Dict, Optional

from perfbench import flops


def _mean(values) -> Optional[float]:
    return sum(values) / len(values) if values else None


def train_mfu(obs: Dict) -> Optional[float]:
    """Model FLOPs of a train step over the mean step time (device
    timeline, the window's unprofiled steps), as a share of the card's
    bfloat16 peak."""
    peak = flops.peak(obs["device_kind"], "bf16_flops")
    step_ms = _mean(obs.get("step_ms"))
    if step_ms is None or peak is None:
        return None
    return 100.0 * obs["step_flops"] / (step_ms / 1e3 * peak)


def fwd_bwd_ms(obs: Dict) -> Optional[float]:
    """Mean time from a train step's start to the optimizer's start."""
    return _mean(obs.get("fwd_bwd_ms"))


def optimizer_ms(obs: Dict) -> Optional[float]:
    """Mean time of the optimizer's update."""
    return _mean(obs.get("optimizer_ms"))


def optimizer_roofline(obs: Dict) -> Optional[float]:
    """The optimizer's least bytes at the card's memory bandwidth over
    its measured time."""
    bw = flops.peak(obs["device_kind"], "hbm_bytes_per_s")
    ms = _mean(obs.get("optimizer_ms"))
    if ms is None or bw is None:
        return None
    return 100.0 * (obs["optimizer_bytes"] / bw) / (ms / 1e3)


def device_idle(obs: Dict) -> Optional[float]:
    """Share of the profiled span in which no device operation ran."""
    t = obs.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def serve_mfu(obs: Dict) -> Optional[float]:
    """Model FLOPs of the requests the unprofiled waves served over
    those waves' host time, as a share of the bfloat16 peak."""
    peak = flops.peak(obs["device_kind"], "bf16_flops")
    if not obs.get("wave_s") or peak is None:
        return None
    return 100.0 * sum(obs["wave_flops"]) / (sum(obs["wave_s"]) * peak)


def wave_s(obs: Dict) -> Optional[float]:
    """Mean host time of the engine's ``run_wave``, unprofiled waves."""
    return _mean(obs.get("wave_s"))
