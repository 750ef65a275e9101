"""Synthetic token data of the port."""
from .pipeline import DataConfig, Pipeline, make_batch  # noqa: F401
