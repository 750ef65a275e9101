"""Carry state between the JAX reference and the port.

Streams: a stream has no weights: its config (shape, seed, kind, salts) and its
sketches (Y, W) are the whole state, so a stream started by the reference
can be continued here and finalize as if one system had seen every update.
The config travels as the reference's ``StreamConfig.to_json_dict()`` (the
dict its checkpoint manifest stores) and the sketches as numpy arrays.

Training: ``params_from_jax`` takes the reference's LM params as a numpy
tree (``jax.device_get`` of them; the attention and FFN groups as dicts,
as ``lm_init`` makes them) and gives the port's, stacked leaves and bf16
included; ``train_state_from_jax`` carries a whole ``TrainState`` (AdamW
moments, count, step, and one worker's error buffers), so both packages
continue from the same point.
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


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float64": torch.float64}


def _tensor(x, device, requires_grad: bool = False) -> torch.Tensor:
    host = np.asarray(x)
    dtype = _TORCH_DTYPES.get(str(host.dtype))
    if dtype is None:
        raise ValueError(f"no torch dtype for {host.dtype}")
    # float32 holds every bfloat16 value exactly; the cast back is exact
    wide = host.astype(np.float64 if dtype == torch.float64 else np.float32)
    t = torch.from_numpy(np.ascontiguousarray(wide)).to(device=device,
                                                         dtype=dtype)
    return t.requires_grad_(requires_grad)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if hasattr(x, "_asdict"):                  # a NamedTuple group
        return _tree(x._asdict(), fn)
    return fn(x)


def params_from_jax(tree, device=None):
    """The port's params (nested dict of leaf tensors that require grad,
    on ``device``; ``None``: the card) from the reference's params as a
    numpy tree."""
    from .core.rng import resolve_device
    device = resolve_device(device)
    return _tree(tree, lambda x: _tensor(x, device, requires_grad=True))


def train_state_from_jax(state, worker: Optional[int] = None, device=None):
    """The port's ``TrainState`` from the reference's (a numpy tree of
    one: ``params``, ``opt`` with ``m``, ``v``, ``count``, ``step``,
    ``error_fb``).  The reference keeps every worker's error buffer under a
    leading world axis (``stack_fb``); ``worker`` picks that worker's slice,
    since a port worker keeps only its own.  With ``worker=None`` the
    buffers are taken as they are (a one-device tree without the axis)."""
    from .core.rng import resolve_device
    from .optim.adamw import AdamWState
    from .train.state import TrainState
    device = resolve_device(device)
    fb = None
    if state.error_fb is not None:
        fb = _tree(state.error_fb, lambda x: _tensor(
            np.asarray(x) if worker is None else np.asarray(x)[worker],
            device))
    opt = AdamWState(m=_tree(state.opt.m, lambda x: _tensor(x, device)),
                     v=_tree(state.opt.v, lambda x: _tensor(x, device)),
                     count=int(np.asarray(state.opt.count)))
    return TrainState(params=params_from_jax(state.params, device), opt=opt,
                      step=int(np.asarray(state.step)), error_fb=fb)
