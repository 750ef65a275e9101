"""Sharded streaming sketch state on a (p1, p2, p3) grid of
torch.distributed ranks (paper Alg. 1 applied once per update; the port
of the reference's ``stream/distributed.py``, dense kinds).

State layout, the streaming extension of Alg. 1's contract.  Grid rank
(i, j, k) holds

  Y (n1 x r)  : block ``output_block`` of Alg. 1's output layout
                P((p1, p2), p3), rows ``(i·p2 + j)·n1/(p1·p2)``, columns
                ``k·r/p3`` — every update's reduce-scatter lands on the
                resident block, so accumulation is a local add;
  W (l  x n2) : block ``corange_block`` of P(None, (p2, p3)), all l rows,
                columns ``(j·p3 + k)·n2/(p2·p3)``, replicated over p1 —
                each full-shape update sums the per-p1 partial
                Psi_i·H_i over the p1 fiber.

A full-shape update moves Alg. 1's words (an all-gather over p3 and a
reduce-scatter over p2; none on the regime-1 grids p2 = p3 = 1) plus, with
the co-range sketch, one all-reduce of l·n2/(p2·p3) words over p1.  A
row slab is replicated over p1 and column-split over (p2, p3): one
all-gather over p3 and one all-reduce of its (k, r/p3) dY over p2
(``plan.model.stream_update_cost``); its W update is local.  No Omega or
Psi entry moves: every rank draws its block from the stream seed (on the
card inside the ``sketch_fwd`` and ``sketch_t`` kernels), and folds dY
into its Y block with the ``fold_rows`` kernel.  Words received are
counted in ``parallel.collectives.COMM``.

A stream is opened on a grid that holds every rank of the world (a
stream block on each); the caller runs
``torch.distributed.init_process_group`` and
``core.sketch.make_grid_groups``.  A live reshard onto a smaller grid
(``stream/elastic.py``) leaves the ranks past it a *standby* stream: no
block, no fiber group; its updates are counted and do no work and no
collective, its queries raise, and a later grow hands it blocks again.  Each update of
:class:`ShardedStreamingSketch` is a comm-ledger site
(``stream.update``, ``stream.update_rows``; ``obs.ledger``): the words
this rank received beside the planner's prediction and the Theorem-2
floor (``ShardedStreamingSketch._audit``).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from repro_torch.core.grid import select_two_grid_executable
from repro_torch.core.kinds import SPARSE_KINDS
from repro_torch.core.nystrom import (nystrom_second_stage_no_redist,
                                      nystrom_second_stage_redist,
                                      nystrom_second_stage_two_grid_fused)
from repro_torch.core.sketch import (GridGroups, gather_output, grid_ordered,
                                     input_block, make_grid_groups,
                                     output_block, resolve_device, seed_keys)
from repro_torch.kernels.local import (fold_rows_block, sketch_block,
                                       sketch_t_block)
from repro_torch.obs import ledger as obs_ledger
from repro_torch.obs import trace as obs_trace
from repro_torch.parallel.collectives import (all_gather, all_reduce,
                                              gather_blocks, reduce_scatter)

from .state import StreamConfig, validate_row_block

__all__ = ["corange_block", "stream_blocks", "gather_corange",
           "standby_error",
           "corange_update", "sharded_update", "sharded_update_rows",
           "update_audit",
           "nystrom_finalize", "ShardedStreamingSketch"]


def _grid_of(mesh, standby: bool = False) -> GridGroups:
    """``mesh`` as a GridGroups on which this rank holds a block (or, with
    ``standby``, any rank of the world); a :class:`repro_torch.plan.Plan`
    in its place gives ``make_grid_groups(*plan.grid)`` (collective over
    the world)."""
    from repro_torch.plan.planner import Plan
    if isinstance(mesh, Plan):
        if mesh.grid is None:
            raise ValueError(f"plan {mesh.variant!r} carries no processor "
                             f"grid")
        mesh = make_grid_groups(*mesh.grid)
    if not isinstance(mesh, GridGroups):
        raise TypeError(f"mesh must be a GridGroups "
                        f"(core.sketch.make_grid_groups) or a "
                        f"repro_torch.plan.Plan; got {mesh!r}")
    if mesh.coords is None and not standby:
        raise ValueError(f"rank {mesh.rank} is past the grid {mesh.shape}: "
                         f"a sharded stream needs a block on every rank")
    return mesh


def standby_error(what: str, g: GridGroups) -> ValueError:
    """The error of a query on a rank past the grid (a standby stream)."""
    return ValueError(f"{what}: rank {g.rank} is past the grid {g.shape} "
                      f"and holds no block (a standby stream after a "
                      f"reshard)")


def refuse_sparse(cfg: StreamConfig) -> None:
    """Sparse kinds have no distributed body, as in the reference."""
    if cfg.kind in SPARSE_KINDS:
        raise NotImplementedError(
            f"kind {cfg.kind!r}: distributed sparse bodies are deferred, "
            f"as in the reference — stream sparse kinds through the local "
            f"StreamingSketch / SketchService")


def check_divisible(cfg: StreamConfig, g) -> None:
    """Refuse a grid (a GridGroups or its shape) that does not divide the
    stream's blocks."""
    p1, p2, p3 = getattr(g, "shape", g)
    if (cfg.n1 % (p1 * p2) or cfg.n2 % (p2 * p3) or cfg.n2 % p2
            or cfg.r % p3):        # n1 % (p1*p2): Y is P((p1, p2), p3)
        raise ValueError(f"stream shape ({cfg.n1},{cfg.n2},r={cfg.r}) "
                         f"not divisible by grid ({p1},{p2},{p3})")


def corange_block(W: torch.Tensor, g: GridGroups) -> torch.Tensor:
    """This rank's block of a full (l, n2) W in P(None, (p2, p3)): all
    rows, columns ``(j·p3 + k)·n2/(p2·p3)`` (a view)."""
    _, p2, p3 = g.shape
    _, j, k = g.coords
    cols = W.shape[1] // (p2 * p3)
    c0 = (j * p3 + k) * cols
    return W[:, c0:c0 + cols]


def stream_blocks(cfg: StreamConfig, g: GridGroups, Y=None, W=None,
                  device=None) -> dict:
    """This rank's stream blocks ``{"Y", "W"}`` (W None without the
    co-range), each its own contiguous tensor of the stream's dtype on
    ``device``: of the full ``Y`` / ``W`` when given, else zeros.  The
    one source of placement at open, eviction-restore and checkpoint
    restore (the reference's ``stream_shardings``)."""
    p1, p2, p3 = g.shape
    device = resolve_device(device)

    def block(full, shape, take):
        out = torch.zeros(shape, dtype=cfg.dtype, device=device)
        return out if full is None else out.copy_(take(full, g))
    blocks = {"Y": block(Y, (cfg.n1 // (p1 * p2), cfg.r // p3),
                         output_block)}
    blocks["W"] = (block(W, (cfg.sketch_l, cfg.n2 // (p2 * p3)),
                         corange_block) if cfg.corange else None)
    return blocks


def gather_corange(W_blk: torch.Tensor, g: GridGroups) -> torch.Tensor:
    """The full W from every grid rank's :func:`corange_block` (for tests,
    checkpoints and the reconstruction; its words are not counted)."""
    p1, p2, p3 = g.shape
    l, cols = W_blk.shape
    blocks = grid_ordered(gather_blocks(W_blk, g.grid_group, g.size), g)
    # replicated over p1: the (p2·p3) column blocks of i = 0, in order
    return (blocks.view(p1, p2 * p3, l, cols)[0].permute(1, 0, 2)
            .reshape(l, p2 * p3 * cols))


def corange_update(W_blk: torch.Tensor, H_blk: torch.Tensor,
                   cfg: StreamConfig, g: GridGroups,
                   seed=None) -> torch.Tensor:
    """``W_blk += Psi·H`` in place, with ``H_blk`` this rank's block of
    Alg. 1's input layout and ``W_blk`` its co-range block: the partial
    Psi[:, i·n1/p1 : (i+1)·n1/p1]·H_blk (``sketch_t_block`` under the
    Psi salt, drawn at its global rows), summed over the p1 fiber by one
    counted all-reduce (2·(1 - 1/p1)·l·n2/(p2·p3) words; none on
    p1 == 1), then added in f32 and rounded once.  ``seed`` defaults to
    the stream's.  Returns ``W_blk``."""
    part = sketch_t_block(H_blk, cfg.seed if seed is None else seed,
                          cfg.sketch_l, row0=g.coords[0] * H_blk.shape[0],
                          kind=cfg.kind, salt=cfg.psi_salt,
                          out_dtype=torch.float32)
    W_blk += all_reduce(part, g.p1_group, g.shape[0])
    return W_blk


def sharded_update(cfg: StreamConfig, keys, Y_blk: torch.Tensor,
                   W_blk: Optional[torch.Tensor], H: torch.Tensor,
                   g: GridGroups) -> None:
    """A <- A + H for a full-shape (n1, n2) delta ``H`` that every rank
    holds, in place on this rank's blocks: its ``input_block`` of H is
    all-gathered over p3 and sketched at Omega's global offsets; on
    p2 == 1 the product accumulates straight into the Y block
    (``sketch_block(acc=Y_blk)``), otherwise its partial is
    reduce-scattered over p2 and added; then :func:`corange_update`."""
    _, p2, p3 = g.shape
    _, j, k = g.coords
    h_blk = input_block(H, g)
    a_ij = all_gather(h_blk, 1, g.p3_group, p3)
    rows, cols = cfg.n2 // p2, cfg.r // p3
    kw = dict(row0=j * rows, col0=k * cols, kind=cfg.kind,
              salt=cfg.omega_salt)
    if p2 == 1:
        sketch_block(a_ij, keys, cols, acc=Y_blk, **kw)
    else:
        part = sketch_block(a_ij, keys, cols, out_dtype=torch.float32, **kw)
        Y_blk += reduce_scatter(part, g.p2_group, p2)
    if W_blk is not None:
        corange_update(W_blk, h_blk, cfg, g, seed=keys)


def sharded_update_rows(cfg: StreamConfig, keys, Y_blk: torch.Tensor,
                        W_blk: Optional[torch.Tensor], row0: int,
                        H: torch.Tensor, g: GridGroups) -> None:
    """Rows [row0, row0 + k) arrive as a (k, n2) slab ``H`` that every
    rank holds, in place on this rank's blocks: its (p2, p3) column block
    is all-gathered over p3 and sketched at Omega's global offsets into
    an f32 dY partial, which one counted all-reduce sums over p2; where
    the slab meets this rank's Y block, ONE ``fold_rows_block`` adds the
    rows of dY that land in it (``start = g0 - row0 + m`` with
    ``g0 = (i·p2 + j)·m``, m = n1/(p1·p2), masked to the k live rows); a
    block the slab does not meet (start outside (0, k + m)) is not
    touched, where the reference adds exact zeros to it; then
    W_blk += Psi[:, row0:row0+k]·H_blk locally
    (``sketch_t_block(acc=W_blk)``)."""
    p1, p2, p3 = g.shape
    i, j, kk = g.coords
    k = H.shape[0]
    width = cfg.n2 // (p2 * p3)
    c0 = (j * p3 + kk) * width
    h_blk = H[:, c0:c0 + width].contiguous()
    h_cols = all_gather(h_blk, 1, g.p3_group, p3)
    om_rows, r_cols = cfg.n2 // p2, cfg.r // p3
    part = sketch_block(h_cols, keys, r_cols, row0=j * om_rows,
                        col0=kk * r_cols, kind=cfg.kind, salt=cfg.omega_salt,
                        out_dtype=torch.float32)
    dY = all_reduce(part, g.p2_group, p2)
    m = cfg.n1 // (p1 * p2)
    start = (i * p2 + j) * m - row0 + m
    if 0 < start < k + m:
        fold_rows_block(Y_blk, dY, start, nvalid=k)
    if W_blk is not None:
        sketch_t_block(h_blk, keys, cfg.sketch_l, row0=row0, kind=cfg.kind,
                       salt=cfg.psi_salt, acc=W_blk)


def nystrom_finalize(Y_blk: torch.Tensor, cfg: StreamConfig, mesh,
                     variant: str = "auto"):
    """(B, C) of a symmetric stream from this rank's block of its
    accumulated Y, through the Alg. 2 second stages under the Omega salt.

    Needs a (P, 1, 1) grid, where Y's blocks are row blocks — the layout
    the second stages take.  ``auto`` follows the paper's crossover:
    redist iff P > n/r.  ``no_redist`` returns (this rank's Y block, C's
    (r/P, r) row block); ``redist`` (B's (n, r/P) column block, C's
    (r, r/P) column block); ``bound_driven`` the general two-grid second
    stage on the bound's q-grid snapped to the min-words executable one
    (``select_two_grid_executable(n, r, P, p=(P, 1, 1))``): (B in the
    q-layout, C in P((q2, q1), q3)).  Words received are the second
    stages' (``core.nystrom``)."""
    with obs_trace.span("stream.nystrom_finalize", cat="stream",
                        variant=variant):
        return _nystrom_finalize(Y_blk, cfg, _grid_of(mesh), variant)


def _nystrom_finalize(Y_blk, cfg, g, variant):
    if cfg.n1 != cfg.n2:
        raise ValueError("Nyström needs a square (symmetric) stream")
    if g.shape[1] != 1 or g.shape[2] != 1:
        raise ValueError(f"streaming Nyström finalize needs a (P,1,1) grid; "
                         f"have {g.shape}")
    Pn = g.shape[0]
    if variant == "auto":
        variant = ("redist" if Pn > max(1, cfg.n1 // max(cfg.r, 1))
                   else "no_redist")
    kw = dict(kind=cfg.kind, salt=cfg.omega_salt)
    if variant == "no_redist":
        return Y_blk, nystrom_second_stage_no_redist(Y_blk, cfg.seed, cfg.r,
                                                     g, **kw)
    if variant == "redist":
        return nystrom_second_stage_redist(Y_blk, cfg.seed, cfg.r, g, **kw)
    if variant == "bound_driven":
        got = select_two_grid_executable(cfg.n1, cfg.r, Pn, p=(Pn, 1, 1))
        if got is None:
            raise ValueError(f"no q-grid factorization of P={Pn} divides "
                             f"(n={cfg.n1}, r={cfg.r})")
        return nystrom_second_stage_two_grid_fused(
            Y_blk, cfg.seed, cfg.r, got[1], p=(Pn, 1, 1), **kw)
    raise ValueError(variant)


def update_audit(cfg: StreamConfig, grid,
                 k: Optional[int] = None) -> Tuple[float, float]:
    """The planner's predicted words and the Theorem-2 floor of one update
    on ``grid`` — the comm ledger's reference numbers.

    ``k=None`` prices a full-shape update — Alg. 1 on the grid plus (when
    the co-range sketch is on) the all-reduce over p1 of the Psi partial,
    ``2(1 - 1/p1)·l·n2/(p2·p3)``.  Integer ``k`` prices an
    ``update_rows`` slab of k rows (``stream_update_cost``; its W update
    is local).  The floor is ``matmul_lower_bound`` of the rows priced, or
    0 where the bound does not apply (r >= n2)."""
    from repro_torch.core.lower_bounds import matmul_lower_bound
    from repro_torch.plan import model as M
    p1, p2, p3 = grid
    if k is None:
        pred = M.alg1_cost(cfg.n1, cfg.n2, cfg.r, grid).words
        if cfg.corange:
            pred += (2.0 * (1.0 - 1.0 / p1)
                     * cfg.sketch_l * cfg.n2 / (p2 * p3))
        rows = cfg.n1
    else:
        pred = M.stream_update_cost(k, cfg.n2, cfg.r, cfg.sketch_l,
                                    grid=grid, corange=cfg.corange).words
        rows = k
    try:
        floor = matmul_lower_bound(rows, cfg.n2, cfg.r, p1 * p2 * p3)
    except ValueError:                  # the paper assumes r < n2
        floor = 0.0
    return float(pred), float(floor)


class ShardedStreamingSketch:
    """Streaming (Y, W) accumulator over a (p1, p2, p3) grid of ranks (a
    standby stream on a rank past the grid, after a reshard).

    Updates arrive as full-shape additive deltas H (zero rows or columns
    where nothing changed; every rank passes the same H) via
    :meth:`update`, or as row slabs via :meth:`update_rows`, without the
    n1 x n2 zero frame.  Both run the communication-optimal collectives
    and add into this rank's resident blocks, in place.  Row-disjoint
    slabs reproduce the one-shot ``rand_matmul`` blocks bitwise where
    p2 = p3 = 1, and ``update_rows`` is bitwise ``update`` on Y (each
    row's partial has the same bits in both: ``sketch_fwd``'s split
    depends on (n, K) alone; a sum of two partials does not depend on
    order).  W is bitwise between the two where each slab lies in one p1
    row block.

    ``mesh`` is ``core.sketch.make_grid_groups(p1, p2, p3)``, holding
    this rank, or a :class:`repro_torch.plan.Plan` (``plan_stream`` /
    ``plan_sketch``) whose grid becomes it; ``device=None`` means the
    card.  Sparse kinds are refused,
    as in the reference.  With a ledger installed (``obs.ledger``) each
    update is observed at the reference's site, against :meth:`_audit`.
    """

    def __init__(self, cfg: StreamConfig, mesh, device=None):
        cfg.validate()
        refuse_sparse(cfg)
        g = _grid_of(mesh)
        check_divisible(cfg, g)
        self.cfg = cfg
        self.mesh = g
        self.device = resolve_device(device)
        blocks = stream_blocks(cfg, g, device=self.device)
        self.Y, self.W = blocks["Y"], blocks["W"]
        self.keys = seed_keys(cfg.seed)
        self.num_updates = 0
        self._audits = {}   # slab rows k (or None) -> (pred words, floor)

    @classmethod
    def _adopt(cls, cfg: StreamConfig, g: GridGroups, device, Y, W,
               num_updates: int) -> "ShardedStreamingSketch":
        """A stream on ``g`` holding the blocks ``Y`` / ``W`` (None on a
        standby rank), as ``stream.elastic.reshard_stream`` hands it
        over."""
        st = cls.__new__(cls)
        st.cfg, st.mesh, st.device = cfg, g, resolve_device(device)
        st.Y, st.W = Y, W
        st.keys = seed_keys(cfg.seed)
        st.num_updates = num_updates
        st._audits = {}
        return st

    @property
    def standby(self) -> bool:
        """True on a rank past the grid: no block, no work, no collective."""
        return self.mesh.coords is None

    def _block(self, what: str) -> None:
        if self.standby:
            raise standby_error(what, self.mesh)

    def _audit(self, k: Optional[int]) -> Tuple[float, float]:
        """Ledger reference numbers (:func:`update_audit`), memoized per
        slab height (the reference's ``_audit``)."""
        hit = self._audits.get(k)
        if hit is None:
            hit = self._audits[k] = update_audit(self.cfg, self.mesh.shape,
                                                 k)
        return hit

    def _as(self, H) -> torch.Tensor:
        return torch.as_tensor(H).to(device=self.device,
                                     dtype=self.cfg.dtype)

    def update(self, H):
        """A <- A + H; H is the full (n1, n2) delta, the same on every
        rank."""
        cfg = self.cfg
        if tuple(H.shape) != (cfg.n1, cfg.n2):
            raise ValueError(f"update shape {tuple(H.shape)} != "
                             f"({cfg.n1}, {cfg.n2})")
        if self.standby:
            self.num_updates += 1
            return self
        H = self._as(H)
        with (obs_ledger.observing("stream.update",
                                   (self.Y, self.W, H, self.mesh.shape),
                                   self._audit, (None,),
                                   itemsize=cfg.dtype.itemsize),
              obs_trace.span("stream.update", cat="stream")):
            sharded_update(cfg, self.keys, self.Y, self.W, H, self.mesh)
        self.num_updates += 1
        return self

    def update_rows(self, row0: int, H):
        """Rows [row0, row0 + k) arrive additively as a (k, n2) slab, the
        same on every rank (:func:`sharded_update_rows`)."""
        validate_row_block(self.cfg, row0, tuple(H.shape))
        if self.standby:
            self.num_updates += 1
            return self
        k = H.shape[0]
        H = self._as(H)
        with (obs_ledger.observing("stream.update_rows",
                                   (self.Y, self.W, H, self.mesh.shape),
                                   self._audit, (k,),
                                   itemsize=self.cfg.dtype.itemsize),
              obs_trace.span("stream.update_rows", cat="stream", k=k)):
            sharded_update_rows(self.cfg, self.keys, self.Y, self.W,
                                int(row0), H, self.mesh)
        self.num_updates += 1
        return self

    # -- checkpointing -----------------------------------------------------

    def save(self, directory: str, step: Optional[int] = None,
             keep: int = 3) -> str:
        """Checkpoint (Y, W, config, num_updates): every rank gathers the
        whole Y and W, grid rank 0 writes them (``checkpoint.ckpt``,
        layout ``"sharded"``) between two barriers, so a restore may take
        another grid.  Returns the checkpoint's path on every rank."""
        import torch.distributed as dist

        from repro_torch.checkpoint import ckpt
        self._block("save")
        g = self.mesh
        step = self.num_updates if step is None else step
        tree = {"Y": gather_output(self.Y, g)}
        if self.W is not None:
            tree["W"] = gather_corange(self.W, g)
        extra = {"config": self.cfg.to_json_dict(),
                 "num_updates": self.num_updates,
                 "backend": "cuda" if self.device.type == "cuda" else "torch",
                 "layout": "sharded"}
        dist.barrier(group=g.grid_group)
        if g.coords == (0, 0, 0):
            ckpt.save(directory, step, tree, extra=extra, keep=keep)
        dist.barrier(group=g.grid_group)
        return os.path.join(directory, f"step_{step:08d}")

    @classmethod
    def restore(cls, directory: str, mesh, step: Optional[int] = None,
                device=None) -> "ShardedStreamingSketch":
        """Rebuild a stream from a checkpoint (sharded or local) onto
        ``mesh``, any grid that divides its shape (elastic restore):
        every rank reads the whole Y and W and keeps its blocks."""
        from repro_torch.checkpoint import ckpt
        tree, _, extra = ckpt.restore_tree(directory, step)
        st = cls(StreamConfig.from_json_dict(extra["config"]), mesh,
                 device=device)
        blocks = stream_blocks(st.cfg, st.mesh, tree["Y"], tree.get("W"),
                               st.device)
        st.Y, st.W = blocks["Y"], blocks["W"]
        st.num_updates = int(extra["num_updates"])
        return st

    # -- finalization ------------------------------------------------------

    @property
    def sketch(self) -> torch.Tensor:
        """This rank's block of Y = A·Omega in P((p1, p2), p3)."""
        self._block("sketch")
        return self.Y

    @property
    def corange_sketch(self) -> Optional[torch.Tensor]:
        """This rank's block of W = Psi·A in P(None, (p2, p3))."""
        self._block("corange_sketch")
        return self.W

    def nystrom(self, variant: str = "auto"):
        """(B, C) of a symmetric stream (:func:`nystrom_finalize`)."""
        self._block("nystrom")
        return nystrom_finalize(self.Y, self.cfg, self.mesh, variant)

    def reconstruct(self, rank: Optional[int] = None, rcond=None):
        """One-pass low-rank reconstruction from the gathered Y and W, on
        every rank."""
        from .reconstruct import one_pass_reconstruct
        self._block("reconstruct")
        if self.W is None:
            raise ValueError("reconstruction needs corange=True")
        return one_pass_reconstruct(gather_output(self.Y, self.mesh),
                                    gather_corange(self.W, self.mesh),
                                    self.cfg, rank=rank, rcond=rcond)
