"""The optimizer's share of its byte roofline, in stablelm-3b.train-4x4096."""
from perfbench.readers import optimizer_roofline as read  # noqa: F401
