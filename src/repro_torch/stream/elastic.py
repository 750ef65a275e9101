"""Live reshard of sharded streaming state (the port of the reference's
``stream/elastic.py``).

Sketch state (Y, W) is a sum of deterministic per-slab updates, so it
does not belong to a grid: re-laying the accumulators onto a grown or
shrunk (p1, p2, p3) grid is one hop with no recompute, and every update
applied after the hop regenerates Omega and Psi at global coordinates and
folds into the moved blocks.  A stream resharded between grids that give
a slab the same sums (any two (P, 1, 1) grids) is bitwise the stream that
never moved; a p2 or p3 split changes a slab's order of summation, on a
stream that never moves as much as on one that does.

The hop.  Every rank of the world calls it.  Each accumulator moves by one
``parallel.collectives.redistribute`` over the world (one uneven
``all_to_all_single``) between its blocks on the two grids, the
rectangles of ``stream.distributed.stream_blocks``; a rank past either
grid holds an empty one.  A rank never receives what it already holds.
W is replicated over p1 in both layouts, so each piece of it comes from
one of its replicas.  :func:`rank_words` gives the words each rank
receives; their maximum is ``plan.model.stream_reshard_words``.

Observability: the counter ``stream_reshard_total`` (one a hop of a
resident stream), the span ``stream.reshard`` (``old``, ``new``,
``path``) and the comm-ledger site ``stream.reshard``
(``obs.ledger.observing``): its measured words are the hop's
``COMM["redistribute"]`` words, its predicted words and floor this rank's
:func:`rank_words`.  ``drain_reshard_resume`` opens the span
``stream.drain_reshard_resume``.

``reshard_stream`` moves one live :class:`ShardedStreamingSketch`;
``SketchService.reshard`` (service.py) moves every stream of a grid
service, evicted ones too; ``drain_reshard_resume`` is the recovery arc
on device loss: drain the ingest queue, reshard the service onto the
surviving grid, resume.

What differs from the reference:

  * The hop moves the min-cut with one all-to-all, and its ledger site
    predicts the words it moves.  The reference's compiled relayout
    moves ``plan.model.stream_reshard_traffic_words`` (full shards) and
    names its ``path`` ``jit`` or ``device_put``; the port's ``path`` is
    ``all_to_all``, or ``none`` when no rank's block changes.
  * Ranks past a smaller grid keep a standby stream (or service).
  * A grid-mode ingest queue applies its lanes in submit order
    (``stream/ingest.py``), so that every rank issues the same sequence
    of collectives.
  * There is no ``devices=`` argument: a grid is the first p1·p2·p3
    ranks of the world, as in ``core.sketch.make_grid_groups``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.sketch import GridGroups, make_grid_groups
from repro_torch.obs import ledger as obs_ledger
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.parallel.collectives import redistribute

from . import faults
from .distributed import ShardedStreamingSketch, check_divisible
from .state import StreamConfig

LEDGER_SITE = "stream.reshard"
_EMPTY = (0, 0, 0, 0)


def _name(grid) -> str:
    return "x".join(map(str, grid))


def _layout(cfg: StreamConfig, shape, world: int,
            order: Optional[Tuple[int, ...]] = None):
    """(Y rectangles, W rectangles or None) of every rank of the world on
    the grid ``shape`` (``order`` as in ``GridGroups``), as
    ``(row0, rows, col0, cols)``; empty past the grid."""
    p1, p2, p3 = shape
    P = p1 * p2 * p3
    m, c, w = cfg.n1 // (p1 * p2), cfg.r // p3, cfg.n2 // (p2 * p3)
    ys, ws = [], []
    for d in range(world):
        if d >= P:
            ys.append(_EMPTY)
            ws.append(_EMPTY)
            continue
        flat = d if order is None else order.index(d)
        i, j, k = flat // (p2 * p3), flat // p3 % p2, flat % p3
        ys.append(((i * p2 + j) * m, m, k * c, c))
        ws.append((0, cfg.sketch_l, (j * p3 + k) * w, w))
    return ys, (ws if cfg.corange else None)


def _received(src, dst) -> List[int]:
    """Words each rank receives re-laying ``src`` as ``dst``: its new
    block less what it already holds of it."""
    out = []
    for a, b in zip(src, dst):
        r0, c0 = max(a[0], b[0]), max(a[2], b[2])
        rows = max(0, min(a[0] + a[1], b[0] + b[1]) - r0)
        cols = max(0, min(a[2] + a[3], b[2] + b[3]) - c0)
        out.append(b[1] * b[3] - rows * cols)
    return out


def _words(cfg: StreamConfig, old, new) -> List[int]:
    (ys, ws), (yd, wd) = old, new
    words = _received(ys, yd)
    if cfg.corange:
        words = [a + b for a, b in zip(words, _received(ws, wd))]
    return words


def rank_words(cfg: StreamConfig, old_grid, new_grid,
               world: Optional[int] = None) -> List[int]:
    """Words each rank of a world of ``world`` (default: the larger
    grid's) receives when a stream of ``cfg`` is resharded from
    ``old_grid`` onto ``new_grid`` (Y, and W with the co-range); their
    maximum is ``plan.model.stream_reshard_words``."""
    P = old_grid[0] * old_grid[1] * old_grid[2]
    Q = new_grid[0] * new_grid[1] * new_grid[2]
    world = max(P, Q) if world is None else world
    return _words(cfg, _layout(cfg, old_grid, world),
                  _layout(cfg, new_grid, world))


def reshard_words(cfg: StreamConfig, old_grid,
                  new_grid) -> Tuple[float, float]:
    """The hop's per-device (schedule words, min-cut floor) for this
    stream, from the planner (``plan/model.py``).  The port's schedule is
    the min-cut, so both are ``stream_reshard_words``."""
    from repro_torch.plan import model as M
    words = M.stream_reshard_words(cfg.n1, cfg.r, tuple(old_grid),
                                   tuple(new_grid), l=cfg.sketch_l,
                                   n2=cfg.n2, corange=cfg.corange)
    return words, words


def move_blocks(cfg: StreamConfig, old: GridGroups, new: GridGroups,
                Y: Optional[torch.Tensor], W: Optional[torch.Tensor],
                device) -> Tuple[Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """This rank's blocks (Y, W) on ``new`` from its blocks on ``old``
    (None where it holds none): one :func:`redistribute` over the world
    for each accumulator, every rank of the world calling.  Exact."""
    import torch.distributed as dist
    world, rank = dist.get_world_size(), dist.get_rank()
    (ys, ws) = _layout(cfg, old.shape, world, old.order)
    (yd, wd) = _layout(cfg, new.shape, world, new.order)

    def one(x, src, dst):
        if x is None:
            x = torch.empty((0, 0), dtype=cfg.dtype, device=device)
        out = redistribute(x, src, dst, rank, None)
        return None if dst[rank] == _EMPTY else out.contiguous()
    Y = one(Y, ys, yd)
    W = one(W, ws, wd) if cfg.corange else None
    return Y, W


def hop(cfg: StreamConfig, old: GridGroups, new: GridGroups,
        Y: Optional[torch.Tensor], W: Optional[torch.Tensor],
        device) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """:func:`move_blocks` of a resident stream, counted
    (``stream_reshard_total``), traced (``stream.reshard``) and observed
    at the ``stream.reshard`` ledger site against this rank's words."""
    import torch.distributed as dist
    world, rank = dist.get_world_size(), dist.get_rank()
    src = _layout(cfg, old.shape, world, old.order)
    dst = _layout(cfg, new.shape, world, new.order)
    words = float(_words(cfg, src, dst)[rank])
    path = "none" if src == dst else "all_to_all"
    obs_metrics.get_metrics().counter(
        "stream_reshard_total",
        "live accumulator resharding hops (elastic resize)").inc()
    with (obs_ledger.observing(LEDGER_SITE, (Y, W, old.shape, new.shape),
                               predicted_words=words,
                               lower_bound_words=words,
                               itemsize=cfg.dtype.itemsize),
          obs_trace.span("stream.reshard", cat="stream",
                         old=_name(old.shape), new=_name(new.shape),
                         path=path)):
        return move_blocks(cfg, old, new, Y, W, device)


def reshard_stream(sk: ShardedStreamingSketch,
                   new_grid: Tuple[int, int, int]) -> ShardedStreamingSketch:
    """Re-lay a LIVE :class:`ShardedStreamingSketch` onto ``new_grid``
    (every rank of the world calls it).

    Returns a stream on the new grid whose (Y, W) are the same numbers,
    moved in one hop: no recompute, no replay.  Updates keep flowing
    afterwards.  The new grid is checked and the ``elastic.reshard`` fault
    point fires before any block moves; a rank past the new grid gets a
    standby stream."""
    new_grid = tuple(int(g) for g in new_grid)
    cfg, old = sk.cfg, sk.mesh
    check_divisible(cfg, new_grid)
    faults.fire("elastic.reshard", old_grid=old.shape, new_grid=new_grid)
    new = make_grid_groups(*new_grid)
    Y, W = hop(cfg, old, new, sk.Y, sk.W, sk.device)
    return ShardedStreamingSketch._adopt(cfg, new, sk.device, Y, W,
                                         sk.num_updates)


def drain_reshard_resume(queue, new_grid: Sequence[int], *,
                         timeout: Optional[float] = None) -> dict:
    """The recovery arc on a lost device, every rank calling:

      1. drain — ``queue.flush``: every accepted request is applied on the
         old grid;
      2. reshard — ``queue.service.reshard(new_grid)``: every stream of
         the service moves in one hop;
      3. resume — the queue keeps accepting; later rounds run on the new
         grid.

    Returns ``{"drained": n_applied, "resharded": n_streams}``.  A pause,
    not a restart: callers stop submitting for its duration."""
    with obs_trace.span("stream.drain_reshard_resume", cat="stream",
                        new=_name(new_grid)):
        drained = queue.flush(timeout=timeout)
        resharded = queue.service.reshard(new_grid)
    return {"drained": drained, "resharded": resharded}
