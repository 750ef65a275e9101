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
                                           tiled=True)``);
  * ``all_reduce(x, group, size)``       — the group's sum of ``x`` on
                                           every rank (``jax.lax.psum``
                                           over one fiber);
  * ``redistribute(x, src, dst, rank, group)`` — the §5.2 Redistribute:
                                           a matrix held in one block
                                           layout re-laid out in another
                                           over the same ranks, by one
                                           uneven all-to-all (the
                                           reference's resharding; also
                                           the live reshard of a stream,
                                           whose W is replicated).

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
term.  A Redistribute receives this rank's destination block less what
it already held: the maximum over ranks is the reference's
``fused_redistribute_words``.  An all-reduce counts what a ring moves
into a rank, ``2·(1 - 1/g)·numel(x)`` (a reduce-scatter, then an
all-gather): the reference's price of the streaming co-range psum and of
``stream_update_cost``'s all-reduce of dY.  (The reference's HLO audit
counts each collective's per-device operand instead; the two agree only
for groups of 2.)

The library never picks a process-group backend: the caller runs
``torch.distributed.init_process_group``.  gloo takes CUDA tensors and
stages them through host memory itself; NCCL is untried.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

KINDS = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all",
         "redistribute")

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


def all_reduce(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The group's sum of ``x``, on every rank of the group (a new
    tensor); ``x`` itself when ``size == 1`` or ``group`` is None."""
    if size == 1 or group is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    COMM["all_reduce"]["calls"] += 1
    words, rem = divmod(2 * (size - 1) * out.numel(), size)
    COMM["all_reduce"]["words"] += words if rem == 0 else words + rem / size
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


def _overlap(a, b):
    """The intersection of two (row0, rows, col0, cols) rectangles, or
    None when it is empty."""
    r0, c0 = max(a[0], b[0]), max(a[2], b[2])
    r1 = min(a[0] + a[1], b[0] + b[1])
    c1 = min(a[2] + a[3], b[2] + b[3])
    if r1 <= r0 or c1 <= c0:
        return None
    return r0, r1 - r0, c0, c1 - c0


def _piece(x: torch.Tensor, at, rect) -> torch.Tensor:
    """The view of ``x`` (a block placed at ``at``) covering ``rect``."""
    return x[rect[0] - at[0]:rect[0] - at[0] + rect[1],
             rect[2] - at[2]:rect[2] - at[2] + rect[3]]


def _senders(src):
    """``send(s, d)``: whether rank ``s`` sends rank ``d`` the part of its
    source block that ``d`` needs.  Ranks whose source blocks are equal
    hold replicas of one block (W over p1): a receiver that holds a
    replica itself takes none, else it takes the block from the
    ``(d mod n)``-th of its ``n`` holders, so each piece arrives once.
    Blocks of one layout must be equal or disjoint."""
    holders = {}
    for d, rect in enumerate(src):
        if rect[1] and rect[3]:
            holders.setdefault(tuple(rect), []).append(d)
    rects = list(holders)
    for a in range(len(rects)):
        for b in range(a + 1, len(rects)):
            if _overlap(rects[a], rects[b]) is not None:
                raise ValueError(f"redistribute: source blocks {rects[a]} "
                                 f"and {rects[b]} overlap without being "
                                 f"equal")

    def send(s, d):
        if s == d:
            return False
        h = holders.get(tuple(src[s]))
        return (h is not None and tuple(src[d]) != tuple(src[s])
                and h[d % len(h)] == s)
    return send


def redistribute(x: torch.Tensor, src, dst, rank: int,
                 group) -> torch.Tensor:
    """This rank's block of a matrix in the layout ``dst``, from its block
    ``x`` in the layout ``src``.

    ``src[d]`` and ``dst[d]`` are the ``(row0, rows, col0, cols)``
    rectangles of the matrix that group rank ``d`` holds before and after
    (an empty one, 0 rows or columns, for a rank that holds nothing);
    every rank passes the same lists.  Between two ranks the piece to
    move is the intersection of the sender's source block with the
    receiver's destination block: the pieces are packed in destination
    order, moved by one ``all_to_all_single`` with uneven splits, and
    unpacked.  What a rank already holds of its destination block is
    copied in place and never sent.  A source layout may replicate a
    block over several ranks; each piece then comes from one of them
    (:func:`_senders`).  A layout move: exact.  ``x`` itself when no
    rank's block changes."""
    if list(src) == list(dst):
        return x
    size, me = len(src), src[rank]
    if tuple(x.shape) != (me[1], me[3]):
        raise ValueError(f"redistribute: block of shape {tuple(x.shape)}, "
                         f"the layout gives rank {rank} {me[1]}x{me[3]}")
    send_to = _senders(src)
    want = dst[rank]
    out = torch.empty((want[1], want[3]), dtype=x.dtype, device=x.device)
    sends, send_sizes, recvs, recv_sizes = [], [], [], []
    for d in range(size):
        give = _overlap(me, dst[d]) if send_to(rank, d) else None
        take = _overlap(src[d], want) if send_to(d, rank) else None
        send_sizes.append(0 if give is None else give[1] * give[3])
        recv_sizes.append(0 if take is None else take[1] * take[3])
        if give is not None:
            sends.append(_piece(x, me, give).reshape(-1))
        recvs.append(take)
    send = (torch.cat(sends) if sends
            else torch.empty(0, dtype=x.dtype, device=x.device))
    recv = torch.empty(sum(recv_sizes), dtype=x.dtype, device=x.device)
    dist.all_to_all_single(recv, send, output_split_sizes=recv_sizes,
                           input_split_sizes=send_sizes, group=group)
    own = _overlap(me, want)
    if own is not None:
        _piece(out, want, own).copy_(_piece(x, me, own))
    at = 0
    for take, n in zip(recvs, recv_sizes):
        if take is not None:
            _piece(out, want, take).copy_(
                recv[at:at + n].view(take[1], take[3]))
        at += n
    COMM["redistribute"]["calls"] += 1
    COMM["redistribute"]["words"] += out.numel() - (
        0 if own is None else own[1] * own[3])
    return out
