"""Elastic scaling of data-parallel training (the reference's
``launch/elastic.py``): resume a DP checkpoint onto another worker count.

A DP checkpoint holds one copy of the replicated params and AdamW moments
and every worker's error buffers (``checkpoint/ckpt.py``).  Elasticity is:

  1. ``remesh``: the process group of the surviving workers, the first
     ``dp`` ranks;
  2. ``elastic_restore``: params and moments copied onto every worker of
     it, and the saved workers' buffers re-laid by
     ``parallel.grad_compress.reshard_error_fb`` (which keeps each leaf's
     worker mean, the only statistic the exchange reads), each worker
     taking its own slice;
  3. the global batch kept: ``make_dp_compressed_step`` splits it by the
     group's size, so fewer workers take bigger shares; ``rescale_accum``
     is the reference's arithmetic for a loop that accumulates instead.

What differs from the reference: a group is ranks, not a device mesh, and
ranks past it stand by (``remesh`` gives them None), as the streams'
``stream/elastic.py`` does.  Tensor parallelism (``tp`` > 1,
``param_shardings``) is item 11 of the roadmap.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.models.api import param_leaves
from repro_torch.parallel.grad_compress import (reshard_error_fb,
                                                worker_rank, world_size)


def remesh(ranks: Sequence[int], dp: int, tp: int = 1):
    """The process group of the first ``dp·tp`` of ``ranks`` (every rank of
    the world calls it: ``torch.distributed.new_group`` is collective);
    None on a rank past it, which stands by."""
    import torch.distributed as dist
    if tp != 1:
        raise NotImplementedError(
            "tp > 1 needs ShardCtx and param_shardings, which are item 11 "
            "of the roadmap (the LM substrate)")
    ranks = [int(r) for r in ranks]
    if not 1 <= dp <= len(ranks):
        raise ValueError(f"dp={dp} workers from {len(ranks)} ranks")
    members = ranks[:dp * tp]
    group = dist.new_group(members)
    return group if dist.get_rank() in members else None


def _my_buffer(load, world_from: int, world_to: int, me: int, name: str,
               device) -> torch.Tensor:
    """Worker ``me``'s buffer ``name`` after ``reshard_error_fb`` of the
    ``world_from`` saved buffers (``load(k)``: worker k's) onto
    ``world_to``, reading only the workers it needs."""
    def stack(workers):
        return torch.stack([load(k)[name].to(device) for k in workers])
    if world_from == world_to:
        return load(me)[name]
    if world_from % world_to == 0:
        g = world_from // world_to
        sub = stack(range(me * g, (me + 1) * g))
        return reshard_error_fb({"x": sub}, g, 1)["x"]
    if world_to % world_from == 0:
        return load(me // (world_to // world_from))[name]
    full = stack(range(world_from))
    return reshard_error_fb({"x": full}, world_from, world_to)["x"][me]


@torch.no_grad()
def elastic_restore(directory: str, state, *, group=None,
                    step: Optional[int] = None):
    """Restore the train-state checkpoint ``step`` (default: the newest
    that loads) into ``state`` in place, on a worker of ``group`` (the
    process group's default without one), whatever the world it was saved
    at; returns ``(state, step, extra)``.  Params and moments are copied;
    this worker's error buffers are its slice of ``reshard_error_fb`` of
    the saved workers' (a checkpoint of one worker is replicated)."""
    manifest, tensors, step, path = ckpt.load_train_step(directory, step)
    world_from = int(manifest.get("world", 1))
    world_to, me = world_size(group), worker_rank(group)
    dp = world_from > 1
    ckpt.copy_into(ckpt.state_tensors(state, error_fb=False), tensors)
    if state.error_fb is not None:
        files = {}

        def load(k):
            if not dp:
                return tensors
            if k not in files:
                files[k] = ckpt.load_rank(path, manifest, k)
            return files[k]
        for n, t in param_leaves(state.error_fb):
            name = f"error_fb.{n}"
            src = _my_buffer(load, world_from, world_to, me, name, t.device)
            ckpt.copy_into({name: t}, {name: src})
            del src
    state.step = manifest["state_step"]
    state.opt.count = manifest["count"]
    return state, step, manifest["extra"]


def rescale_accum(global_batch: int, per_device_batch: int,
                  dp_size: int) -> Tuple[int, int]:
    """(accum_steps, effective_global_batch) preserving the global batch."""
    denom = per_device_batch * dp_size
    accum = max(1, global_batch // denom)
    return accum, accum * denom
