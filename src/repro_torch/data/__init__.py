"""Synthetic data of the port: token streams and the stub frontends'
features."""
from .pipeline import (DataConfig, Pipeline, data_config_for,  # noqa: F401
                       make_batch)
