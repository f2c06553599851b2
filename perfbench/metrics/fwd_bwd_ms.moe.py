"""Forward and backward ms of a train step, in olmoe-1b-7b.train-4x4096."""
from perfbench.readers import fwd_bwd_ms as read  # noqa: F401
