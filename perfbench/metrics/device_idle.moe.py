"""The device's idle share over profiled steps, in olmoe-1b-7b.train-4x4096."""
from perfbench.readers import device_idle as read  # noqa: F401
