"""The optimizer's ms a step, in stablelm-3b.train-4x4096."""
from perfbench.readers import optimizer_ms as read  # noqa: F401
