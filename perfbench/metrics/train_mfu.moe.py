"""Share of the bf16 peak a train step reaches, in olmoe-1b-7b.train-4x4096."""
from perfbench.readers import train_mfu as read  # noqa: F401
