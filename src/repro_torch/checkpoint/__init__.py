"""Atomic train-state checkpoints of the port."""
from . import ckpt  # noqa: F401
