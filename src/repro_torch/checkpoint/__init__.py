"""Atomic checkpoints of the port: of a train state, or of a tree of
named tensors (the streams')."""
from . import ckpt  # noqa: F401
