"""Atomic checkpoints of a train state (the port's own format; it does not
read the reference's).

Layout: ``<dir>/step_<N>/`` holding ``tensors.pt`` (every tensor of the
state by name, on the CPU) and ``manifest.json`` (step, optimizer count,
``extra``).  Everything is written into ``step_<N>.tmp``, fsynced, and
published with one ``os.replace``, so a reader never sees a half-written
step; ``latest_step`` reports only steps whose manifest and tensors load.
``restore`` copies into the tensors of a live state, in place.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models.api import param_leaves

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _named(state) -> Dict[str, torch.Tensor]:
    trees = {"params": state.params, "opt.m": state.opt.m,
             "opt.v": state.opt.v}
    if state.error_fb is not None:
        trees["error_fb"] = state.error_fb
    return {f"{p}.{n}": t for p, tree in trees.items()
            for n, t in param_leaves(tree)}


def _fsync_write(path: str, writer) -> None:
    with open(path, "wb") as f:
        writer(f)
        f.flush()
        os.fsync(f.fileno())


def save(directory: str, step: int, state, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Atomically write ``state`` as step ``step``; returns its path and
    keeps the newest ``keep`` steps."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        tensors = {k: t.detach().cpu() for k, t in _named(state).items()}
        manifest = {"step": int(step), "state_step": int(state.step),
                    "count": int(state.opt.count), "extra": extra or {},
                    "names": sorted(tensors)}
        _fsync_write(os.path.join(tmp, "tensors.pt"),
                     lambda f: torch.save(tensors, f))
        _fsync_write(os.path.join(tmp, "manifest.json"),
                     lambda f: f.write(json.dumps(manifest).encode()))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for _, d in _step_dirs(directory)[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    return final


def _step_dirs(directory: str) -> List[Tuple[int, str]]:
    out = []
    for d in os.listdir(directory):
        m = _STEP_RE.match(d)
        if m:
            out.append((int(m.group(1)), d))
    return sorted(out)


def _load(path: str):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tensors = torch.load(os.path.join(path, "tensors.pt"),
                         map_location="cpu", weights_only=True)
    if sorted(tensors) != manifest["names"]:
        raise ValueError(f"{path}: tensors and manifest disagree")
    return manifest, tensors


def latest_step(directory: str) -> Optional[int]:
    """The newest step that loads, or None."""
    if not os.path.isdir(directory):
        return None
    for s, d in reversed(_step_dirs(directory)):
        try:
            _load(os.path.join(directory, d))
        except (OSError, ValueError, KeyError, RuntimeError):
            continue
        return s
    return None


@torch.no_grad()
def restore(directory: str, state, step: Optional[int] = None):
    """Copy checkpoint ``step`` (default: the newest that loads) into the
    tensors of ``state`` in place; returns ``(state, step, extra)``."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no loadable checkpoint in {directory}")
    manifest, tensors = _load(os.path.join(directory, f"step_{step:08d}"))
    for name, t in _named(state).items():
        if name not in tensors:
            raise KeyError(f"checkpoint lacks {name!r}")
        src = tensors[name]
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{tuple(src.shape)} vs {tuple(t.shape)}")
        t.copy_(src)
    state.step = manifest["state_step"]
    state.opt.count = manifest["count"]
    return state, step, manifest["extra"]
