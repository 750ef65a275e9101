"""Carry a stream's state between the JAX reference and the port.

A stream has no weights: its config (shape, seed, kind, salts) and its
sketches (Y, W) are the whole state, so a stream started by the reference
can be continued here and finalize as if one system had seen every update.
The config travels as the reference's ``StreamConfig.to_json_dict()`` (the
dict its checkpoint manifest stores) and the sketches as numpy arrays.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .stream.state import StreamConfig, StreamingSketch


def _load(dst: torch.Tensor, src, name: str) -> None:
    host = np.asarray(src)
    if tuple(host.shape) != tuple(dst.shape):
        raise ValueError(f"{name} has shape {host.shape}, the config "
                         f"wants {tuple(dst.shape)}")
    # float32 (float64 for f64 streams) holds every bfloat16 value exactly
    wide = np.float64 if dst.dtype == torch.float64 else np.float32
    dst.copy_(torch.from_numpy(np.ascontiguousarray(host.astype(wide))))


def stream_from_jax(config_json: dict, Y, W: Optional[np.ndarray],
                    num_updates: int, device=None) -> StreamingSketch:
    """A :class:`StreamingSketch` holding a reference stream's state."""
    st = StreamingSketch(StreamConfig.from_json_dict(config_json),
                         device=device)
    _load(st.Y, Y, "Y")
    if st.W is not None:
        if W is None:
            raise ValueError("the config tracks W (corange) but W is None")
        _load(st.W, W, "W")
    st.num_updates = int(num_updates)
    return st


def stream_to_numpy(st: StreamingSketch) -> Tuple[dict, np.ndarray,
                                                  Optional[np.ndarray], int]:
    """``(config_json, Y, W, num_updates)``, the arguments of
    :func:`stream_from_jax`.  bfloat16 sketches come out as float32."""
    def host(t):
        if t is None:
            return None
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return st.cfg.to_json_dict(), host(st.Y), host(st.W), st.num_updates
