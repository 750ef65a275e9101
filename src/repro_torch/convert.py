"""Carry state between the JAX reference and the port.

Streams: a stream has no weights: its config (shape, seed, kind, salts) and its
sketches (Y, W) are the whole state, so a stream started by the reference
can be continued here and finalize as if one system had seen every update.
The config travels as the reference's ``StreamConfig.to_json_dict()`` (the
dict its checkpoint manifest stores) and the sketches as numpy arrays.

Training: ``params_from_jax`` takes the reference's LM params as a numpy
tree (``jax.device_get`` of them; the attention and FFN groups as dicts,
as ``lm_init`` makes them) and gives the port's, stacked leaves included,
each leaf in its own dtype (a bf16 model's f32 router, ``A_log``, ``D``
and ``dt_bias`` stay f32); ``cache_from_jax`` does the same for a decode
cache; ``train_state_from_jax`` carries a whole ``TrainState`` (AdamW
moments, count, step, and one worker's error buffers), so both packages
continue from the same point; ``train_state_from_checkpoint`` reads the
same state from a checkpoint directory the reference wrote
(``repro.checkpoint.ckpt.save``: ``manifest.json`` and ``arrays.npz``),
with numpy alone.
"""
from __future__ import annotations

import json
import os
from types import SimpleNamespace
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
    if isinstance(x, torch.Tensor):           # decoded from raw bits
        return x.to(device).requires_grad_(requires_grad)
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
    if isinstance(x, (list, tuple)):           # e.g. the hybrid's KV list
        return [_tree(v, fn) for v in x]
    return fn(x)


def params_from_jax(tree, device=None):
    """The port's params (nested dict of leaf tensors that require grad,
    on ``device``; ``None``: the card) from the reference's params as a
    numpy tree, each leaf in its own dtype."""
    from .core.rng import resolve_device
    device = resolve_device(device)
    return _tree(tree, lambda x: _tensor(x, device, requires_grad=True))


def cache_from_jax(cache, device=None):
    """The port's decode cache (tensors on ``device``; ``None``: the card)
    from a reference cache as a numpy tree: the dense family's per-layer
    list, or the SSM and hybrid families' dict of stacked states (the
    hybrid's ``shared`` a list of ``{"k", "v"}``)."""
    from .core.rng import resolve_device
    device = resolve_device(device)
    return _tree(cache, lambda x: _tensor(x, device))


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
            x if worker is None else (x[worker] if isinstance(
                x, torch.Tensor) else np.asarray(x)[worker]), device))
    opt = AdamWState(m=_tree(state.opt.m, lambda x: _tensor(x, device)),
                     v=_tree(state.opt.v, lambda x: _tensor(x, device)),
                     count=int(np.asarray(state.opt.count)))
    return TrainState(params=params_from_jax(state.params, device), opt=opt,
                      step=int(np.asarray(state.step)), error_fb=fb)


# The reference stores a dtype numpy lacks (bf16, fp8) as a raw view of
# its bits, the dtype's name in the manifest: the view and torch's dtype.
_RAW_DTYPES = {"bfloat16": (np.int16, torch.bfloat16),
               "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
               "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def _decode(arr: np.ndarray, dtype: str):
    """A stored leaf as numpy (a numpy dtype) or as a torch tensor that
    reinterprets the raw bits (a dtype numpy lacks)."""
    try:
        want = np.dtype(dtype)
    except TypeError:
        want = None
    if want is not None:
        return arr if arr.dtype == want else arr.view(want)
    if dtype not in _RAW_DTYPES:
        raise ValueError(f"no torch dtype for the stored dtype {dtype!r}")
    view, tdtype = _RAW_DTYPES[dtype]
    return torch.from_numpy(np.ascontiguousarray(arr).view(view)).view(
        tdtype)


def _reference_complete(path: str) -> bool:
    """The reference's ``is_complete``: the manifest parses and
    ``arrays.npz`` holds every leaf it names."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as arrays:
            have = set(arrays.files)
        return all(e["key"] in have for e in manifest["leaves"])
    except Exception:  # noqa: BLE001 — missing file, bad zip, bad JSON
        return False


def _reference_step(directory: str, step: Optional[int]) -> str:
    from .checkpoint.ckpt import TornCheckpointError, _step_dirs
    if step is None:
        done = [s for s, d in _step_dirs(directory)
                if _reference_complete(os.path.join(directory, d))]
        if not done:
            raise FileNotFoundError(f"no loadable checkpoints in "
                                    f"{directory}")
        step = done[-1]
    path = os.path.join(directory, f"step_{step:08d}")
    if not _reference_complete(path):
        raise TornCheckpointError(
            f"checkpoint step {step} in {directory} is torn (incomplete "
            f"manifest/arrays) and will not be loaded")
    return path


def _nest(named):
    """``{"a/b/c": x}`` as nested dicts."""
    out = {}
    for name, x in named.items():
        node = out
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = x
    return out


def train_state_from_checkpoint(directory: str, step: Optional[int] = None,
                                worker: Optional[int] = None, device=None):
    """The port's ``TrainState`` from a ``TrainState`` checkpoint that the
    reference's ``checkpoint/ckpt.py`` wrote into ``directory`` (step
    ``step``, default the newest complete one), read with numpy alone.
    Leaves are matched by the reference's names (``params/...``,
    ``opt/m/...``, ``opt/v/...``, ``opt/count``, ``step``,
    ``error_fb/...``); a bf16 leaf comes back from its stored bits.
    ``worker`` picks a worker's error buffers from the stacked world axis,
    as in :func:`train_state_from_jax`.  A torn step raises
    ``TornCheckpointError``, as the reference's restore does."""
    path = _reference_step(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        named = {e["name"]: _decode(arrays[e["key"]], e["dtype"])
                 for e in manifest["leaves"]}
    tree = _nest(named)
    state = SimpleNamespace(params=tree["params"],
                            opt=SimpleNamespace(**tree["opt"]),
                            step=tree["step"],
                            error_fb=tree.get("error_fb"))
    return train_state_from_jax(state, worker=worker, device=device)
