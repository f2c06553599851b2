"""Data pipeline of the port: the reference's synthetic LM stream, copied
(numpy batches, byte for byte the reference's)."""
from .pipeline import DataConfig, SyntheticLMDataset, make_dataset

__all__ = ["DataConfig", "SyntheticLMDataset", "make_dataset"]
