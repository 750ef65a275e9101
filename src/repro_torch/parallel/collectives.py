"""The tiled collectives of Alg. 1 and Alg. 2, counted.

  * ``all_gather(x, dim, group, size)``  — the ``size`` blocks of a group
                                           concatenated along ``dim``
                                           (``jax.lax.all_gather(...,
                                           axis=dim, tiled=True)``);
  * ``reduce_scatter(x, group, size)``   — the group's sum of ``x``, row
                                           block ``rank`` of it kept
                                           (``jax.lax.psum_scatter(...,
                                           scatter_dimension=0,
                                           tiled=True)``);
  * ``all_to_all(x, group, size)``       — the (n/g, r) row blocks of the
                                           group re-laid out as this rank's
                                           (n, r/g) column block
                                           (``jax.lax.all_to_all(...,
                                           split_axis=1, concat_axis=0,
                                           tiled=True)``).

``torch.distributed``'s flat all-gather concatenates along dim 0, so a
gather along another dim lands in a ``(size, *x.shape)`` buffer and is
laid out once by a copy: a layout move, exact.  A group of size 1 makes
no call and moves nothing.  The all-to-all lays its send buffer out as
``(g, n/g, r/g)`` (one exact copy), so ``all_to_all_single``'s received
buffer already is the ``(n, r/g)`` column block.

``COMM`` records, by kind, the calls made and the words THIS rank
receives: ``(1 - 1/g)·numel(full)`` for a group of g, where ``full`` is
the gathered tensor or the reduce-scatter's input, or the all-to-all's
output (``(1 - 1/g)·n·r/g``), counted from the tensors handed to the
collective.  Summed over Alg. 1's two collectives that is
``core.grid.alg1_bandwidth_words`` on every grid; the 1-D No-Redist
Alg. 2 receives ``alg2_bandwidth_words(n, r, (P,1,1), (P,1,1))``, and
the Redist all-to-all ``(1 - 1/P)·n·r/P``, below the formula's ``n·r/P``
term.  (The reference's HLO audit counts each collective's per-device
operand instead; the two agree only for groups of 2.)

The library never picks a process-group backend: the caller runs
``torch.distributed.init_process_group``.  gloo takes CUDA tensors and
stages them through host memory itself; NCCL is untried.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

KINDS = ("all_gather", "reduce_scatter", "all_to_all")

# The flat (dim-0) collectives under this torch's name for them: newer
# releases call them ``*_single`` and deprecate the ``*_tensor`` names,
# which are the only ones older releases have.
_all_gather_flat = (getattr(dist, "all_gather_single", None)
                    or dist.all_gather_into_tensor)
_reduce_scatter_flat = (getattr(dist, "reduce_scatter_single", None)
                        or dist.reduce_scatter_tensor)

# Calls and words received by this rank since the last reset_comm().
COMM = {kind: {"calls": 0, "words": 0} for kind in KINDS}


def reset_comm() -> None:
    for rec in COMM.values():
        rec["calls"] = 0
        rec["words"] = 0


def comm_words() -> int:
    """Words this rank received over every kind since the last reset."""
    return sum(rec["words"] for rec in COMM.values())


def _count(kind: str, full: torch.Tensor, mine: torch.Tensor) -> None:
    COMM[kind]["calls"] += 1
    COMM[kind]["words"] += full.numel() - mine.numel()


def gather_blocks(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The ``size`` ranks' ``x`` stacked as ``(size, *x.shape)`` in group
    rank order (uncounted; ``all_gather`` counts)."""
    buf = torch.empty((size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _all_gather_flat(buf, x.contiguous(), group=group)
    return buf.view(size, *x.shape)


def all_gather(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The group's ``x`` blocks concatenated along ``dim`` in group rank
    order; ``x`` itself when ``size == 1``."""
    if size == 1:
        return x
    full = gather_blocks(x, group, size).movedim(0, dim)
    shape = list(x.shape)
    shape[dim] *= size
    out = full.reshape(shape)
    _count("all_gather", out, x)
    return out


def reduce_scatter(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """Row block ``rank`` of the group's sum of ``x`` (dim 0 split
    ``size`` ways); ``x`` itself when ``size == 1``."""
    if size == 1:
        return x
    if x.shape[0] % size:
        raise ValueError(f"reduce_scatter: {x.shape[0]} rows do not split "
                         f"{size} ways")
    x = x.contiguous()
    out = torch.empty((x.shape[0] // size, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _reduce_scatter_flat(out, x, group=group)
    _count("reduce_scatter", x, out)
    return out


def all_to_all(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """This rank's ``(n, r/size)`` column block from the group's
    ``(n/size, r)`` row blocks ``x`` (row block j from group rank j);
    ``x`` itself when ``size == 1``."""
    if size == 1:
        return x
    rows, cols = x.shape
    if cols % size:
        raise ValueError(f"all_to_all: {cols} columns do not split {size} "
                         f"ways")
    # chunk k of the send buffer (dim 0) goes to group rank k: its columns
    send = x.reshape(rows, size, cols // size).permute(1, 0, 2).contiguous()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group)
    # every chunk has the same size; one of them stays on this rank
    _count("all_to_all", out, send[0])
    return out.view(size * rows, cols // size)
