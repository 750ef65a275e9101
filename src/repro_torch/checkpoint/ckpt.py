"""Atomic checkpoints (the port's own format; it does not read the
reference's), of a train state or of a tree of named tensors.

Layout: ``<dir>/step_<N>/`` holding ``tensors.pt`` (every tensor by name,
on the CPU) and ``manifest.json`` (step, ``extra``, the names, and for a
train state its step and optimizer count).  Everything is written into
``step_<N>.tmp``, fsynced, and published with one ``os.replace``, so a
reader never sees a half-written step.

Torn steps, as in the reference.  A step is complete when its manifest
parses, its ``tensors.pt`` loads and the two name the same tensors
(:func:`is_complete`).  A torn one (a copy cut short, an older writer, or
the ``ckpt.pre_commit`` fault point of ``stream/faults.py``, which fires
between staging and the ``os.replace``) is never loaded: ``latest_step``
skips it, an explicit ``restore`` / ``restore_tree`` of it raises
:class:`TornCheckpointError`, ``torn_steps`` lists it and
``quarantine_torn`` renames it to ``step_<N>.torn``.

Two forms share that writer:

  * a train state: ``save(directory, step, state)``; ``restore`` copies
    into the tensors of a live state, in place;
  * a tree, ``{name: tensor}`` (the reference's ``ckpt.save`` of a
    pytree): ``save(directory, step, tree)``; ``load_extra`` reads the
    manifest's ``extra`` alone and ``restore_tree`` returns the tensors,
    on the CPU, with ``extra``.  Tensors are stored whole (the caller
    gathers a sharded one first), so a restore may lay them out on
    another grid.
"""
from __future__ import annotations

import json
import os
import pickle
import re
import shutil
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.models.api import param_leaves

_STEP_RE = re.compile(r"^step_(\d{8})$")


class TornCheckpointError(RuntimeError):
    """An explicitly requested checkpoint step exists but is torn
    (incomplete manifest or tensors) and will not be loaded."""


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


def _write(directory: str, step: int, tensors: Dict[str, torch.Tensor],
           manifest: Dict, keep: int) -> str:
    """Atomically publish ``tensors`` and ``manifest`` as step ``step``;
    keep the newest ``keep`` steps.  The ``ckpt.pre_commit`` fault point
    fires between staging and publishing: a fault raised there publishes
    nothing."""
    from repro_torch.stream import faults
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        manifest = dict(manifest, step=int(step), names=sorted(tensors))
        _fsync_write(os.path.join(tmp, "tensors.pt"),
                     lambda f: torch.save(tensors, f))
        _fsync_write(os.path.join(tmp, "manifest.json"),
                     lambda f: f.write(json.dumps(manifest).encode()))
        # a handler here that tears the staged files makes the commit
        # below publish a torn step, as a non-atomic writer would
        faults.fire("ckpt.pre_commit", tmp=tmp, final=final, step=step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for _, d in _step_dirs(directory)[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    return final


def save(directory: str, step: int, state, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Atomically write ``state`` as step ``step``; returns its path and
    keeps the newest ``keep`` steps.  ``state`` is a train state or a
    ``{name: tensor}`` dict (stored whole, on the CPU)."""
    if isinstance(state, dict):
        tensors = {str(k): t.detach().cpu() for k, t in state.items()}
        return _write(directory, step, tensors, {"extra": extra or {}},
                      keep)
    tensors = {k: t.detach().cpu() for k, t in _named(state).items()}
    return _write(directory, step, tensors,
                  {"state_step": int(state.step),
                   "count": int(state.opt.count), "extra": extra or {}},
                  keep)


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


def is_complete(path: str) -> bool:
    """True iff the step directory ``path`` loads: its manifest parses,
    its ``tensors.pt`` loads, and the two name the same tensors."""
    try:
        _load(path)
    except (OSError, EOFError, ValueError, KeyError, RuntimeError,
            pickle.UnpicklingError):    # missing, cut short, or bad JSON
        return False
    return True


def torn_steps(directory: str) -> List[int]:
    """Steps present on disk that do not load (skipped by
    ``latest_step``, refused by ``restore``)."""
    if not os.path.isdir(directory):
        return []
    return [s for s, d in _step_dirs(directory)
            if not is_complete(os.path.join(directory, d))]


def quarantine_torn(directory: str) -> List[int]:
    """Rename every torn ``step_<N>`` to ``step_<N>.torn`` (idempotent),
    so that it stops shadowing good steps; returns their numbers."""
    out = []
    for s in torn_steps(directory):
        src = os.path.join(directory, f"step_{s:08d}")
        dst = src + ".torn"
        if os.path.exists(dst):
            shutil.rmtree(src, ignore_errors=True)
        else:
            os.replace(src, dst)
        out.append(s)
    return out


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step, or None (torn steps are skipped; see
    :func:`torn_steps`)."""
    if not os.path.isdir(directory):
        return None
    for s, d in reversed(_step_dirs(directory)):
        if is_complete(os.path.join(directory, d)):
            return s
    return None


def _resolve(directory: str, step: Optional[int]) -> int:
    if step is not None:
        return step
    step = latest_step(directory)
    if step is None:
        torn = torn_steps(directory)
        raise FileNotFoundError(
            f"no loadable checkpoint in {directory}"
            + (f" (torn steps present: {torn})" if torn else ""))
    return step


def _load_step(directory: str, step: int):
    """(manifest, tensors) of step ``step``; TornCheckpointError when the
    step exists but does not load."""
    path = os.path.join(directory, f"step_{step:08d}")
    if os.path.isdir(path) and not is_complete(path):
        raise TornCheckpointError(
            f"checkpoint step {step} in {directory} is torn (incomplete "
            f"manifest/tensors) and will not be loaded; see "
            f"ckpt.torn_steps / ckpt.quarantine_torn")
    return _load(path)


def load_extra(directory: str,
               step: Optional[int] = None) -> Tuple[Dict, int]:
    """``(extra, step)`` of checkpoint ``step`` (default: the newest that
    loads), from its manifest alone: a stream reads its config here
    before it allocates what it restores into."""
    step = _resolve(directory, step)
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)["extra"], step


def restore_tree(directory: str, step: Optional[int] = None
                 ) -> Tuple[Dict[str, torch.Tensor], int, Dict]:
    """``(tensors, step, extra)`` of checkpoint ``step`` (default: the
    newest that loads): every stored tensor by name, on the CPU."""
    step = _resolve(directory, step)
    manifest, tensors = _load_step(directory, step)
    return tensors, step, manifest["extra"]


@torch.no_grad()
def restore(directory: str, state, step: Optional[int] = None):
    """Copy checkpoint ``step`` (default: the newest that loads) into the
    tensors of ``state`` in place; returns ``(state, step, extra)``."""
    step = _resolve(directory, step)
    manifest, tensors = _load_step(directory, step)
    if "state_step" not in manifest:
        raise ValueError(f"checkpoint step {step} in {directory} holds a "
                         f"tree of tensors, not a train state; use "
                         f"restore_tree")
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
