"""repro_torch.data — the deterministic synthetic data pipeline."""

from .pipeline import DataConfig, SyntheticLMData, make_batch_struct

__all__ = ["DataConfig", "SyntheticLMData", "make_batch_struct"]
