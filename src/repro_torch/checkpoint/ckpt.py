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
  * a data-parallel train state at ``world`` > 1 workers
    (``save(..., world=P, group=g)``, every rank of the group calling).
    The params and AdamW moments are the same on every worker; the error
    buffers are each worker's own.  Each rank stages its buffers into
    ``step_<N>.tmp`` as ``error_fb.rank<k>.pt``, then a barrier; rank 0
    alone writes ``tensors.pt`` (params, moments) and the manifest, which
    records ``world`` and the rank files, and publishes with the one
    ``os.replace``; then a barrier.  The buffers never travel between
    ranks.  A step is complete only when every rank file the manifest
    names loads too.  ``restore(..., world=P, group=g)`` gives each rank
    its own buffers; onto another world, ``launch.elastic.elastic_restore``
    re-lays them;
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


def state_tensors(state, error_fb: bool = True) -> Dict[str, torch.Tensor]:
    trees = {"params": state.params, "opt.m": state.opt.m,
             "opt.v": state.opt.v}
    if error_fb and state.error_fb is not None:
        trees["error_fb"] = state.error_fb
    return {f"{p}.{n}": t for p, tree in trees.items()
            for n, t in param_leaves(tree)}


def rank_file(k: int) -> str:
    """The file of worker ``k``'s error buffers in a DP step directory."""
    return f"error_fb.rank{k}.pt"


def _fsync_write(path: str, writer) -> None:
    with open(path, "wb") as f:
        writer(f)
        f.flush()
        os.fsync(f.fileno())


def _stage(directory: str, step: int) -> Tuple[str, str]:
    """A fresh ``step_<N>.tmp`` (a crashed save's leftover removed);
    returns ``(final, tmp)``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    return final, tmp


def _publish(directory: str, step: int, final: str, tmp: str,
             tensors: Dict[str, torch.Tensor], manifest: Dict,
             keep: int) -> str:
    """Write ``tensors`` and ``manifest`` into the staged ``tmp`` and
    publish it as ``final``; keep the newest ``keep`` steps.  The
    ``ckpt.pre_commit`` fault point fires between staging and publishing:
    a fault raised there publishes nothing."""
    from repro_torch.stream import faults
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


def _write(directory: str, step: int, tensors: Dict[str, torch.Tensor],
           manifest: Dict, keep: int) -> str:
    """Atomically publish ``tensors`` and ``manifest`` as step ``step``."""
    final, tmp = _stage(directory, step)
    return _publish(directory, step, final, tmp, tensors, manifest, keep)


def _buffers(state):
    """``(name, tensor)`` of the state's error buffers (none without)."""
    return [] if state.error_fb is None else param_leaves(state.error_fb)


def _agree(ok: bool, group) -> bool:
    """A barrier over ``group`` that also tells every rank whether all of
    them got there without a fault."""
    import torch.distributed as dist
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return bool(flag.item())


def _save_dp(directory: str, step: int, state, extra: Dict, keep: int,
             world: int, group) -> str:
    """The DP form of :func:`save` (see the module's docstring); every
    rank of ``group`` calls it.  A fault on any rank makes every rank
    raise and publishes nothing."""
    from repro_torch.parallel.grad_compress import worker_rank
    me = worker_rank(group)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    err: Optional[BaseException] = None
    if me == 0:
        try:
            _stage(directory, step)
        except Exception as e:  # noqa: BLE001 — every rank learns of it
            err = e
    if not _agree(err is None, group):
        raise err or RuntimeError(f"rank 0 could not stage {tmp}")
    fb = {f"error_fb.{n}": t.detach().cpu() for n, t in _buffers(state)}
    try:
        _fsync_write(os.path.join(tmp, rank_file(me)),
                     lambda f: torch.save(fb, f))
    except Exception as e:  # noqa: BLE001 — every rank learns of it
        err = e
    del fb
    if not _agree(err is None, group):
        if me == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        raise err or RuntimeError(f"a rank could not write its error "
                                  f"buffers into {tmp}")
    if me == 0:
        tensors = {k: t.detach().cpu()
                   for k, t in state_tensors(state, error_fb=False).items()}
        rank_names = sorted(f"error_fb.{n}" for n, _ in _buffers(state))
        try:
            _publish(directory, step, final, tmp, tensors,
                     {"state_step": int(state.step),
                      "count": int(state.opt.count), "extra": extra,
                      "world": int(world),
                      "rank_files": [rank_file(k) for k in range(world)],
                      "rank_names": rank_names}, keep)
        except BaseException as e:  # noqa: BLE001 — every rank learns of it
            err = e
        del tensors
    if not _agree(err is None, group):
        raise err or RuntimeError(f"rank 0 could not publish step {step} "
                                  f"in {directory}")
    return final


def save(directory: str, step: int, state, extra: Optional[Dict] = None,
         keep: int = 3, *, world: int = 1, group=None) -> str:
    """Atomically write ``state`` as step ``step``; returns its path and
    keeps the newest ``keep`` steps.  ``state`` is a train state or a
    ``{name: tensor}`` dict (stored whole, on the CPU).  A train state at
    ``world`` > 1 workers is saved in the DP form, every rank of ``group``
    (the process group's ranks 0..world-1) calling."""
    if isinstance(state, dict):
        tensors = {str(k): t.detach().cpu() for k, t in state.items()}
        return _write(directory, step, tensors, {"extra": extra or {}},
                      keep)
    if world > 1:
        return _save_dp(directory, step, state, extra or {}, keep, world,
                        group)
    tensors = {k: t.detach().cpu() for k, t in state_tensors(state).items()}
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
    for k in range(len(manifest.get("rank_files", ()))):
        load_rank(path, manifest, k)
    return manifest, tensors


def load_rank(path: str, manifest: Dict, k: int) -> Dict[str, torch.Tensor]:
    """Worker ``k``'s error buffers of the DP step directory ``path``, on
    the CPU and memory-mapped (a restore reads only what it copies)."""
    fb = torch.load(os.path.join(path, manifest["rank_files"][k]),
                    map_location="cpu", weights_only=True, mmap=True)
    if sorted(fb) != manifest["rank_names"]:
        raise ValueError(f"{path}: {manifest['rank_files'][k]} and the "
                         f"manifest disagree")
    return fb


_TORN = (OSError, EOFError, ValueError, KeyError, RuntimeError,
         pickle.UnpicklingError)     # missing, cut short, or bad JSON


def is_complete(path: str) -> bool:
    """True iff the step directory ``path`` loads: its manifest parses,
    its ``tensors.pt`` loads, and the two name the same tensors; in the
    DP form, every rank file the manifest names loads and names the
    manifest's buffers too."""
    try:
        _load(path)
    except _TORN:
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
    try:
        return _load(path)
    except _TORN:
        if not os.path.isdir(path):
            raise
    raise TornCheckpointError(
        f"checkpoint step {step} in {directory} is torn (incomplete "
        f"manifest/tensors) and will not be loaded; see "
        f"ckpt.torn_steps / ckpt.quarantine_torn")


def load_train_step(directory: str, step: Optional[int] = None):
    """``(manifest, tensors, step, path)`` of the train-state checkpoint
    ``step`` (default: the newest that loads); in the DP form ``tensors``
    holds the params and moments and :func:`load_rank` reads each worker's
    buffers."""
    step = _resolve(directory, step)
    manifest, tensors = _load_step(directory, step)
    if "state_step" not in manifest:
        raise ValueError(f"checkpoint step {step} in {directory} holds a "
                         f"tree of tensors, not a train state; use "
                         f"restore_tree")
    return manifest, tensors, step, os.path.join(directory,
                                                 f"step_{step:08d}")


def copy_into(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]
              ) -> None:
    """Copy every tensor of ``dst`` from the same name in ``src``."""
    for name, t in dst.items():
        if name not in src:
            raise KeyError(f"checkpoint lacks {name!r}")
        if tuple(src[name].shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{tuple(src[name].shape)} vs {tuple(t.shape)}")
        t.copy_(src[name])


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
def restore(directory: str, state, step: Optional[int] = None, *,
            world: int = 1, group=None):
    """Copy checkpoint ``step`` (default: the newest that loads) into the
    tensors of ``state`` in place; returns ``(state, step, extra)``.  A DP
    checkpoint restores at the world it was saved at, each rank of
    ``group`` taking its own buffers."""
    from repro_torch.parallel.grad_compress import worker_rank
    manifest, tensors, step, path = load_train_step(directory, step)
    saved = int(manifest.get("world", 1))
    dp = saved > 1
    if dp and saved != world:
        raise ValueError(
            f"checkpoint step {step} in {directory} holds the buffers of "
            f"{saved} workers, not {world}; restore it onto another world "
            f"with launch.elastic.elastic_restore")
    copy_into(state_tensors(state, error_fb=not dp), tensors)
    if dp:
        copy_into({f"error_fb.{n}": t for n, t in _buffers(state)},
                  load_rank(path, manifest, worker_rank(group)))
    state.step = manifest["state_step"]
    state.opt.count = manifest["count"]
    return state, step, manifest["extra"]
