"""The device's idle share over a profiled wave, in stablelm-3b.serve-longprompt."""
from perfbench.readers import device_idle as read  # noqa: F401
