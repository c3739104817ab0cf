"""Synthetic token data of the port."""

from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline

__all__ = ["DataConfig", "SyntheticTokenPipeline"]
