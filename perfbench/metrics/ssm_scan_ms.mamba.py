"""The selective scan's device ms a step, in falcon-mamba-7b.train-4x4096:
the profiled steps' time of the device operations named
``selective_scan_*`` among the trace's longest (forward, replay and
backward; the ~1 ms reduction ranks outside them, so this is a lower
bound)."""
from perfbench.families.mamba1 import scan_ms as read  # noqa: F401
