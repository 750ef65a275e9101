"""Nystrom approximation (paper §5): the one-device oracle and Alg. 2 on
torch.distributed.

For a symmetric A (n x n): B = A·Omega (n x r), C = Omega^T·B (r x r), and
Ã = B · C† · B^T.  The two 1-D variants of §5.3 run on P ranks in a
(P, 1, 1) grid (``make_grid_groups(P, 1, 1)``), from each rank's row block
of A (``input_block``):

  * ``nystrom_no_redist`` — every rank draws the full Omega and sketches
    its rows (no word moves), forms the partial C_i = Omega_i^T·B_i and
    reduce-scatters it: (1 - 1/P)·r² words received.  B and C come out as
    row blocks.
  * ``nystrom_redist`` — the same first stage, then one all-to-all re-lays
    B out from row blocks to column blocks ((1 - 1/P)·n·r/P words
    received) and C's column block is local.  B and C come out as column
    blocks.

The two-grid Alg. 2 (§5.3 approach 1) runs stage 1, Alg. 1, on a
(p1, p2, p3) grid and stage 2 on a (q1, q2, q3) grid over the same ranks:

  * ``nystrom_two_grid`` / ``nystrom_two_grid_fused`` — independent
    factorizations of P, both row-major over ranks 0 .. P-1 (the form
    Theorem 3's bound-driven grids take); ``nystrom_auto(variant=
    "bound_driven")`` picks the pair (``select_two_grid_executable``);
  * ``nystrom_general`` — the q-grid is the p-grid's axes permuted;
  * ``nystrom_second_stage_two_grid`` / ``_fused`` — stage 2 alone from a
    B in a p-layout (default (P, 1, 1): a streamed accumulator's row
    blocks) under a ``salt``.

Between the stages the §5.2 Redistribute moves B from its stage-1 layout
P((p1, p2), p3) to P(q1, (q3, q2)) by one counted uneven all-to-all
(``parallel.collectives.redistribute``); stage 2 all-gathers B over q2,
sketches C's partial and reduce-scatters it over q1.  B comes out in the
q-layout and C in P((q2, q1), q3) (``two_grid_block``).

The fused forms are comm-ledger sites (``obs.ledger``:
``nystrom.two_grid_fused``, ``nystrom.stage2_two_grid_fused``): the words
this rank received beside ``alg2_fused_cost`` and the Theorem-3 floor
(``_fused_audit``).  The second stages take a ``salt``, so a streamed
accumulator can finalize through them.  On the card the first stage is
the ``sketch_fwd`` kernel and the second ``sketch_t``; the dense Omega is
never formed and never moves.  The distributed entry points run where the
caller's tensors lie.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.obs import ledger as obs_ledger
from repro_torch.obs import trace as obs_trace

from .sketch import (GridGroups, _dense_only, grid_ordered, input_block,
                     make_grid_groups, omega_tile, rand_matmul,
                     validate_kind)


def nystrom_reference(A: torch.Tensor, seed, r: int, kind: str = "normal"):
    """(B, C) with Omega materialized (the same Philox Omega as every other
    path)."""
    validate_kind(kind)
    om = omega_tile(seed, 0, 0, A.shape[0], r, kind, A.dtype,
                    device=A.device)
    B = A @ om
    return B, om.T @ B


def _default_rcond(dtype) -> float:
    """1e-12 in float64 (the paper's FP64 cutoff); in reduced precision
    the cutoff sits above the dtype's noise floor."""
    return 1e-12 if dtype == torch.float64 else 1e-6


def reconstruct(B: torch.Tensor, C: torch.Tensor,
                rcond: Optional[float] = None) -> torch.Tensor:
    """Ã = B C† B^T, the pseudo-inverse from an eigendecomposition of the
    symmetrized C with a relative eigenvalue cutoff."""
    rcond = _default_rcond(C.dtype) if rcond is None else rcond
    w, V = torch.linalg.eigh((C + C.T) / 2)
    cutoff = rcond * w.abs().max()
    w_inv = torch.where(w.abs() > cutoff, 1.0 / w, torch.zeros_like(w))
    Cd = (V * w_inv[None, :]) @ V.T
    return B @ Cd @ B.T


def relative_error(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                   rcond: Optional[float] = None) -> torch.Tensor:
    """|| A - Ã ||_F / || A ||_F  (the paper's Tab. 2 metric)."""
    return (torch.linalg.norm(A - reconstruct(B, C, rcond))
            / torch.linalg.norm(A))


# ---------------------------------------------------------------------------
# The 1-D Alg. 2 (p = (P, 1, 1); q = p for No-Redist, (1, 1, P) for Redist)
# ---------------------------------------------------------------------------

# the dim along which each variant's B and C are split over the P ranks
_BLOCK_DIM = {"no_redist": 0, "redist": 1}


def _not_divisible(n: int, r: int, P: int) -> ValueError:
    return ValueError(f"n={n}, r={r} must divide P={P}")


def _sketch_rows_1d(A_blk: Optional[torch.Tensor], seed, r: int,
                    g: GridGroups, kind: str) -> Optional[torch.Tensor]:
    """B_i = A_i·Omega from this rank's (n/P, n) row block: every rank
    draws the full Omega (Alg. 1 on (P, 1, 1)); no word moves.  None past
    the grid."""
    _dense_only(kind)
    if g.coords is None:
        return None
    from repro_torch.kernels.local import sketch_block
    P = g.size
    rows, n = A_blk.shape
    if n % P or r % P:
        raise _not_divisible(n, r, P)
    if rows * P != n:
        raise ValueError(f"A block of shape ({rows},{n}) is not a row "
                         f"block of an {n}x{n} A over P={P}")
    return sketch_block(A_blk, seed, r, kind=kind)


def nystrom_second_stage_no_redist(B_blk: Optional[torch.Tensor], seed,
                                   r: int, g: GridGroups,
                                   kind: str = "normal", salt: int = 0
                                   ) -> Optional[torch.Tensor]:
    """This rank's (r/P, r2) row block of C = Omega^T·B from its (n/P, r2)
    row block of B: the partial Omega_i^T·B_i drawn at row ``i·n/P``
    (``sketch_t_block``), then one reduce-scatter over the P ranks; B
    never moves.  None past the grid."""
    _dense_only(kind)
    if g.coords is None:
        return None
    from repro_torch.kernels.local import sketch_t_block
    from repro_torch.parallel.collectives import reduce_scatter
    P, rows = g.size, B_blk.shape[0]
    if r % P:
        raise _not_divisible(rows * P, r, P)
    c_part = sketch_t_block(B_blk, seed, r, row0=g.coords[0] * rows,
                            kind=kind, salt=salt)
    return reduce_scatter(c_part, g.grid_group, P)


def nystrom_second_stage_redist(B_blk: Optional[torch.Tensor], seed, r: int,
                                g: GridGroups, kind: str = "normal",
                                salt: int = 0):
    """(B's (n, r/P) column block, C's (r, r/P) column block) from this
    rank's (n/P, r) row block of B: one all-to-all re-lays B out, then
    C's block is the local ``sketch_t_block`` over the full Omega.
    (None, None) past the grid."""
    _dense_only(kind)
    if g.coords is None:
        return None, None
    from repro_torch.kernels.local import sketch_t_block
    from repro_torch.parallel.collectives import all_to_all
    P, rows = g.size, B_blk.shape[0]
    if r % P:
        raise _not_divisible(rows * P, r, P)
    b_k = all_to_all(B_blk, g.grid_group, P)
    return b_k, sketch_t_block(b_k, seed, r, kind=kind, salt=salt)


def nystrom_no_redist(A_blk: Optional[torch.Tensor], seed, r: int,
                      g: GridGroups, kind: str = "normal"):
    """The paper's No-Redist variant from this rank's row block ``A_blk =
    input_block(A, g)`` on ``g = make_grid_groups(P, 1, 1)``: (B's
    (n/P, r) row block, C's (r/P, r) row block); one reduce-scatter,
    (1 - 1/P)·r² words received.  (None, None) past the grid."""
    B = _sketch_rows_1d(A_blk, seed, r, g, kind)
    if B is None:
        return None, None
    return B, nystrom_second_stage_no_redist(B, seed, r, g, kind)


def nystrom_redist(A_blk: Optional[torch.Tensor], seed, r: int,
                   g: GridGroups, kind: str = "normal"):
    """The paper's Redist variant, in and on what :func:`nystrom_no_redist`
    takes: (B's (n, r/P) column block, C's (r, r/P) column block); one
    all-to-all, (1 - 1/P)·n·r/P words received.  (None, None) past the
    grid."""
    B = _sketch_rows_1d(A_blk, seed, r, g, kind)
    if B is None:
        return None, None
    return nystrom_second_stage_redist(B, seed, r, g, kind)


def nystrom_auto(A: torch.Tensor, seed, r: int, variant: str = "auto",
                 P_procs: Optional[int] = None, kind: str = "normal",
                 plan=None):
    """Alg. 2 on the first ``P_procs`` ranks (default: the world), from the
    full A that every rank holds.

    variant:
      * ``"auto"`` — the paper's empirical rule: redist iff P > n/r;
      * ``"no_redist"`` / ``"redist"`` — explicit, on (P, 1, 1);
      * ``"bound_driven"`` — the two-grid Alg. 2 on the Theorem-3 (p, q)
        pair, snapped to the min-words executable pair when the ideal
        grids do not divide (``select_two_grid_executable``), through
        :func:`nystrom_two_grid_fused`;
      * ``"plan"`` — the cost model's choice (``plan.plan_nystrom``; the
        same as passing ``plan=plan_nystrom(n, r, P=P)``).
    plan: a :class:`repro_torch.plan.Plan` (wins over ``variant``): the
    two-grid variants run on its (p, q) pair, the 1-D ones on (P, 1, 1),
    and ``local_torch`` runs no_redist, as the reference maps its
    ``local_xla``; a ``cuda_fused`` plan is no grid program (call
    ``plan.execute``).
    Returns ``(B_blk, C_blk, GridGroups, variant)``: row blocks on
    (P, 1, 1) for no_redist, column blocks for redist, the q-layouts on
    the q-grid for bound_driven (None past the grid)."""
    import torch.distributed as dist
    _dense_only(kind)
    P = P_procs or dist.get_world_size()
    n = A.shape[0]
    if plan is not None or variant == "plan":
        from repro_torch.plan.planner import Plan, plan_nystrom
        if plan is None:
            plan = plan_nystrom(n, r, P=P, kind=kind)
        if not isinstance(plan, Plan):
            raise TypeError(f"plan must be a repro_torch.plan.Plan "
                            f"(plan_nystrom); got {plan!r}")
        if not plan.executable:
            raise ValueError(
                f"plan {plan.variant!r} for dims={plan.dims}, "
                f"P={plan.n_procs} is analytic-only (no executable grid "
                f"pair divides the shape)")
        if plan.variant in ("alg2_bound_driven", "alg2_bound_driven_fused"):
            fn = (nystrom_two_grid_fused
                  if plan.variant == "alg2_bound_driven_fused"
                  else nystrom_two_grid)
            B, C = fn(input_block(A, make_grid_groups(*plan.grid)), seed, r,
                      p=plan.grid, q=plan.q_grid, kind=kind)
            return B, C, make_grid_groups(*plan.q_grid), "bound_driven"
        variant = {"alg2_no_redist": "no_redist", "alg2_redist": "redist",
                   "local_torch": "no_redist"}.get(plan.variant)
        if variant is None:
            raise ValueError(f"plan variant {plan.variant!r} has no 1-D "
                             f"grid execution here; call plan.execute "
                             f"instead (or pass variant='auto' to force "
                             f"the grid path)")
    if variant == "bound_driven":
        from .grid import select_two_grid_executable
        got = select_two_grid_executable(n, r, P)
        if got is None:
            raise ValueError(f"no (p, q) factorization pair of P={P} "
                             f"divides (n={n}, r={r}); pad the shape or "
                             f"change P")
        p, q, _exact = got
        B, C = nystrom_two_grid_fused(input_block(A, make_grid_groups(*p)),
                                      seed, r, p=p, q=q, kind=kind)
        return B, C, make_grid_groups(*q), "bound_driven"
    if variant == "auto":
        variant = "redist" if P > max(1, n // max(r, 1)) else "no_redist"
    fn = {"no_redist": nystrom_no_redist,
          "redist": nystrom_redist}.get(variant)
    if fn is None:
        raise ValueError(variant)
    if n % P or r % P:
        raise _not_divisible(n, r, P)
    g = make_grid_groups(P, 1, 1)
    B, C = fn(input_block(A, g), seed, r, g, kind=kind)
    return B, C, g, variant


def nystrom_block(X: torch.Tensor, g: GridGroups,
                  variant: str) -> Optional[torch.Tensor]:
    """This rank's block of a full B or C in ``variant``'s output layout:
    row block i (no_redist) or column block i (redist) of the (P, 1, 1)
    grid (a view; None past the grid)."""
    if g.coords is None:
        return None
    dim = _BLOCK_DIM[variant]
    size = X.shape[dim] // g.size
    return X.narrow(dim, g.coords[0] * size, size)


def nystrom_gather(blk: Optional[torch.Tensor], g: GridGroups,
                   variant: str) -> Optional[torch.Tensor]:
    """The full B or C from every grid rank's :func:`nystrom_block` (for
    tests and checks; its words are not counted).  None past the grid."""
    if g.coords is None:
        return None
    from repro_torch.parallel.collectives import gather_blocks
    blocks = gather_blocks(blk, g.grid_group, g.size)
    return torch.cat(tuple(blocks), dim=_BLOCK_DIM[variant])


# ---------------------------------------------------------------------------
# The two-grid Alg. 2 (§5.3 approach 1): stage 1 on a (p1, p2, p3) grid,
# stage 2 on a (q1, q2, q3) grid over the same ranks, the §5.2
# Redistribute of B between them
# ---------------------------------------------------------------------------

def _b_p_rect(coords, p, n: int, r: int):
    """B's block at p-coordinates (i, j, k) in stage 1's layout
    P((p1, p2), p3), as (row0, rows, col0, cols)."""
    p1, p2, p3 = p
    i, j, k = coords
    rows, cols = n // (p1 * p2), r // p3
    return (i * p2 + j) * rows, rows, k * cols, cols


def _q_rect(coords, q, part: str, n: int, m: int):
    """The block at q-coordinates (i', j', k') of an (n, m) B in stage 2's
    layout P(q1, (q3, q2)) (``part`` "B": columns (q3, q2)-major) or of
    an (n, m) C in P((q2, q1), q3) (``part`` "C")."""
    q1, q2, q3 = q
    i, j, k = coords
    if part == "B":
        rows, cols = n // q1, m // (q2 * q3)
        return i * rows, rows, (k * q2 + j) * cols, cols
    if part == "C":
        rows, cols = n // (q1 * q2), m // q3
        return (j * q1 + i) * rows, rows, k * cols, cols
    raise ValueError(f"part must be 'B' or 'C'; got {part!r}")


def _second_stage(B_blk: torch.Tensor, seed, r: int, gp: GridGroups,
                  gq: GridGroups, n: int, kind: str, salt: int):
    """(B in the q-layout, C in P((q2, q1), q3)) from this rank's block of
    B in gp's layout: the Redistribute, the all-gather over q2, the local
    ``sketch_t_block`` of Omega[i'·n/q1:, j'·r/q2:]ᵀ·B[i', k'], the
    reduce-scatter over q1."""
    from repro_torch.kernels.local import sketch_t_block
    from repro_torch.parallel.collectives import (all_gather, redistribute,
                                                  reduce_scatter)
    q1, q2, _ = gq.shape
    ranks = range(gq.size)
    src = [_b_p_rect(gp.coords_of(d), gp.shape, n, r) for d in ranks]
    dst = [_q_rect(gq.coords_of(d), gq.shape, "B", n, r) for d in ranks]
    b_q = redistribute(B_blk, src, dst, gq.rank, gq.grid_group)
    i, j, _ = gq.coords
    b_ik = all_gather(b_q, 1, gq.p2_group, q2)
    om_rows, om_cols = n // q1, r // q2
    c_part = sketch_t_block(b_ik, seed, om_cols, row0=i * om_rows,
                            col0=j * om_cols, kind=kind, salt=salt)
    return b_q, reduce_scatter(c_part, gq.p1_group, q1)


def _fused_audit(n: int, r: int, p, q) -> Tuple[float, float]:
    """(predicted words, Theorem-3 floor) of the fused two-grid forms —
    the ledger's reference numbers (the reference's ``_fused_audit``):
    ``plan.model.alg2_fused_cost``, the stage collectives plus the
    Redistribute at what moves, and ``nystrom_lower_bound`` (0 where the
    bound does not apply, r >= n)."""
    from repro_torch.plan import model as M
    from .lower_bounds import nystrom_lower_bound
    try:
        floor = nystrom_lower_bound(n, r, p[0] * p[1] * p[2])
    except ValueError:                  # the paper assumes r < n
        floor = 0.0
    words = M.alg2_fused_cost(n, r, tuple(p), tuple(q)).words
    return float(words), float(floor)


def _same_P(p, q) -> None:
    if math.prod(p) != math.prod(q):
        raise ValueError(f"grids must factor the same P: {p} vs {q}")


def _stage2_checked(B_blk: Optional[torch.Tensor], r: int, q, p):
    """The p- and q-grids of a second stage (every rank makes both), and
    B's n from this rank's block; the reference's checks, in its order.
    (gp, gq, None) past the grid."""
    q = tuple(int(x) for x in q)
    p = (math.prod(q), 1, 1) if p is None else tuple(int(x) for x in p)
    _same_P(p, q)
    gp, gq = make_grid_groups(*p), make_grid_groups(*q)
    if gp.coords is None:
        return gp, gq, None
    rows, cols = B_blk.shape
    n = rows * p[0] * p[1]
    if cols * p[2] != r:
        raise ValueError(f"B must be (n, r); got {(n, cols * p[2])} with "
                         f"r={r}")
    q1, q2, q3 = q
    if n % q1 or r % (q1 * q2) or r % (q2 * q3):
        raise ValueError(f"(n={n}, r={r}) not divisible by q-grid "
                         f"({q1},{q2},{q3}): needs q1 | n, q1*q2 | r, "
                         f"q2*q3 | r")
    return gp, gq, n


def nystrom_second_stage_two_grid(B_blk: Optional[torch.Tensor], seed,
                                  r: int, q: Tuple[int, int, int],
                                  p: Optional[Tuple[int, int, int]] = None,
                                  kind: str = "normal", salt: int = 0):
    """Stage 2 of Alg. 2 on the (q1, q2, q3) grid from this rank's block
    of B in the p-layout P((p1, p2), p3) (``p`` default (P, 1, 1): a
    streamed accumulator's row blocks): the §5.2 Redistribute to
    P(q1, (q3, q2)), then, as Alg. 1 with the grid's roles shifted, the
    all-gather of B over q2, Omega_{i'j'} drawn at its global offsets, the
    local product and the reduce-scatter of C over q1.

    Returns (B's block in P(q1, (q3, q2)), C's block in P((q2, q1), q3));
    (None, None) past the grid.  Words received: this rank's q-block less
    what it held of it, + (1 - 1/q2)·n·r/(q1·q3)
    + (1 - 1/q1)·r²/(q2·q3)."""
    _dense_only(kind)
    gp, gq, n = _stage2_checked(B_blk, r, q, p)
    if n is None:
        return None, None
    return _second_stage(B_blk, seed, r, gp, gq, n, kind, salt)


def nystrom_second_stage_two_grid_fused(
        B_blk: Optional[torch.Tensor], seed, r: int,
        q: Tuple[int, int, int], p: Optional[Tuple[int, int, int]] = None,
        kind: str = "normal", salt: int = 0):
    """:func:`nystrom_second_stage_two_grid` under the reference's fused
    contract and trace span (``"nystrom.stage2_two_grid_fused"``).

    The reference compiles the Redistribute and stage 2 into one program
    over the shared mesh of (p, q).  Here both grids always share one rank
    order, so the Redistribute of every (p, q) pair is the same one
    all-to-all and the two forms run one program; where
    ``two_grid_shared_mesh`` is None this takes the reference's fallback
    call, :func:`nystrom_second_stage_two_grid`."""
    _dense_only(kind)
    from .grid import two_grid_shared_mesh
    gp, gq, n = _stage2_checked(B_blk, r, q, p)
    if n is None:
        return None, None
    if two_grid_shared_mesh(gp.shape, gq.shape) is None:
        return nystrom_second_stage_two_grid(B_blk, seed, r, gq.shape,
                                             p=gp.shape, kind=kind,
                                             salt=salt)
    with (obs_ledger.observing("nystrom.stage2_two_grid_fused",
                               (B_blk, gp.shape, gq.shape),
                               _fused_audit, (n, r, gp.shape, gq.shape),
                               itemsize=B_blk.dtype.itemsize),
          obs_trace.span("nystrom.stage2_two_grid_fused", cat="nystrom",
                         n=n, r=r, p=list(gp.shape), q=list(gq.shape))):
        return _second_stage(B_blk, seed, r, gp, gq, n, kind, salt)


def _two_grid_checked(name: str, A_blk: Optional[torch.Tensor], r: int,
                      p, q, kind: str):
    """The p- and q-grids of a two-grid run (every rank makes both) and
    A's n from this rank's block; the reference's checks, in its order.
    (gp, gq, None) past the grid."""
    if p is None or q is None:
        raise ValueError(f"{name} needs explicit p and q grids (use "
                         f"nystrom_auto(variant='bound_driven') to pick "
                         f"them from the bound)")
    _dense_only(kind)
    from .grid import alg2_two_grid_executable
    p = tuple(int(x) for x in p)
    q = tuple(int(x) for x in q)
    _same_P(p, q)
    gp, gq = make_grid_groups(*p), make_grid_groups(*q)
    if gp.coords is None:
        return gp, gq, None
    rows, cols = A_blk.shape
    shape = (rows * p[0], cols * p[1] * p[2])
    n = shape[0]
    if shape[1] != n:
        raise ValueError(f"Nyström needs a square A; got {shape}")
    if not alg2_two_grid_executable(n, r, p, q):
        raise ValueError(f"(n={n}, r={r}) not divisible by grids p={p}, "
                         f"q={q} (see alg2_two_grid_executable)")
    return gp, gq, n


def nystrom_two_grid(A_blk: Optional[torch.Tensor], seed, r: int,
                     p: Tuple[int, int, int] = None,
                     q: Tuple[int, int, int] = None, kind: str = "normal"):
    """Alg. 2 with stage 1 on grid ``p`` and stage 2 on grid ``q`` (§5.3),
    two factorizations of the same P, each row-major over ranks 0 .. P-1.

    in : this rank's block of A, ``input_block(A, make_grid_groups(*p))``
    out: (B's block in P(q1, (q3, q2)), C's block in P((q2, q1), q3)) on
         the q-grid (``two_grid_block``); (None, None) past the grid.
    Stage 1 is :func:`rand_matmul`; B is then redistributed to the
    q-layout (the §5.2 Redistribute, one uneven all-to-all, at most n·r/P
    words a rank when p != q, none when the layouts coincide) and stage 2
    runs on the q-grid."""
    gp, gq, n = _two_grid_checked("nystrom_two_grid", A_blk, r, p, q, kind)
    if n is None:
        return None, None
    B = rand_matmul(A_blk, seed, r, gp, kind=kind)
    return _second_stage(B, seed, r, gp, gq, n, kind, 0)


def nystrom_two_grid_fused(A_blk: Optional[torch.Tensor], seed, r: int,
                           p: Tuple[int, int, int] = None,
                           q: Tuple[int, int, int] = None,
                           kind: str = "normal"):
    """:func:`nystrom_two_grid` under the reference's fused contract and
    trace span (``"nystrom.two_grid_fused"``).

    The reference compiles both stages and the Redistribute into one
    program over the shared mesh of (p, q) instead of a cross-mesh
    transfer.  Here both grids always share one rank order, so the
    Redistribute of every (p, q) pair is the same one all-to-all and the
    two forms run one program; where ``two_grid_shared_mesh`` is None this
    takes the reference's fallback call, :func:`nystrom_two_grid`."""
    from .grid import two_grid_shared_mesh
    gp, gq, n = _two_grid_checked("nystrom_two_grid_fused", A_blk, r, p, q,
                                  kind)
    if n is None:
        return None, None
    if two_grid_shared_mesh(gp.shape, gq.shape) is None:
        return nystrom_two_grid(A_blk, seed, r, p=gp.shape, q=gq.shape,
                                kind=kind)
    with (obs_ledger.observing("nystrom.two_grid_fused",
                               (A_blk, gp.shape, gq.shape),
                               _fused_audit, (n, r, gp.shape, gq.shape),
                               itemsize=A_blk.dtype.itemsize),
          obs_trace.span("nystrom.two_grid_fused", cat="nystrom", n=n, r=r,
                         p=list(gp.shape), q=list(gq.shape))):
        B = rand_matmul(A_blk, seed, r, gp, kind=kind)
        return _second_stage(B, seed, r, gp, gq, n, kind, 0)


def permuted_grid_groups(g: GridGroups,
                         q_perm: Optional[Tuple[int, int, int]] = None
                         ) -> GridGroups:
    """The q-grid of :func:`nystrom_general`: q-axis m is ``g``'s axis
    ``q_perm[m]`` (default (0, 1, 2)), over the same ranks.  Collective
    over the world, as ``make_grid_groups``."""
    q_perm = (0, 1, 2) if q_perm is None else tuple(int(a) for a in q_perm)
    if sorted(q_perm) != [0, 1, 2]:
        raise ValueError(f"q_perm must permute the axes (0, 1, 2); got "
                         f"{q_perm}")
    q = tuple(g.shape[a] for a in q_perm)
    order = []
    for f in range(g.size):
        qc = (f // (q[1] * q[2]), f // q[2] % q[1], f % q[2])
        pc = [0, 0, 0]
        for m, a in enumerate(q_perm):
            pc[a] = qc[m]
        flat = (pc[0] * g.shape[1] + pc[1]) * g.shape[2] + pc[2]
        order.append(flat if g.order is None else g.order[flat])
    return make_grid_groups(*q, order=tuple(order))


def nystrom_general(A_blk: Optional[torch.Tensor], seed, r: int,
                    g: GridGroups,
                    q_perm: Optional[Tuple[int, int, int]] = None,
                    kind: str = "normal"):
    """Alg. 2 with stage 2 on the p-grid ``g``'s axes permuted: q-axis m
    is p-axis ``q_perm[m]`` (default (0, 1, 2): q = p), so the rank at
    p-coordinates c has q-coordinates (c[q_perm[0]], c[q_perm[1]],
    c[q_perm[2]]) (the reference's ``q_axes`` over one mesh).  In and out
    as :func:`nystrom_two_grid`, on the permuted q-grid; (None, None)
    past the grid."""
    _dense_only(kind)
    gq = permuted_grid_groups(g, q_perm)
    if g.coords is None:
        return None, None
    n = A_blk.shape[0] * g.shape[0]
    q1, q2, q3 = gq.shape
    if n % q1 or r % (q2 * q3) or r % q2 or r % q3:
        raise ValueError(f"(n={n}, r={r}) not divisible by q-grid "
                         f"({q1},{q2},{q3})")
    B = rand_matmul(A_blk, seed, r, g, kind=kind)
    return _second_stage(B, seed, r, g, gq, n, kind, 0)


def two_grid_block(X: torch.Tensor, g: GridGroups,
                   part: str) -> Optional[torch.Tensor]:
    """This rank's block of a full B (``part`` "B", layout P(q1, (q3, q2)))
    or C (``part`` "C", layout P((q2, q1), q3)) on the q-grid ``g`` (a
    view; None past the grid)."""
    if g.coords is None:
        return None
    r0, rows, c0, cols = _q_rect(g.coords, g.shape, part, *X.shape)
    return X[r0:r0 + rows, c0:c0 + cols]


def two_grid_gather(blk: Optional[torch.Tensor], g: GridGroups,
                    part: str) -> Optional[torch.Tensor]:
    """The full B or C from every grid rank's :func:`two_grid_block` (for
    tests and checks; its words are not counted).  None past the grid."""
    if g.coords is None:
        return None
    from repro_torch.parallel.collectives import gather_blocks
    q1, q2, q3 = g.shape
    rows, cols = blk.shape
    full = ((rows * q1, cols * q2 * q3) if part == "B"
            else (rows * q1 * q2, cols * q3))
    out = blk.new_empty(full)
    blocks = grid_ordered(gather_blocks(blk, g.grid_group, g.size), g)
    for f in range(g.size):
        coords = (f // (q2 * q3), f // q3 % q2, f % q3)
        r0, _, c0, _ = _q_rect(coords, g.shape, part, *full)
        out[r0:r0 + rows, c0:c0 + cols] = blocks[f]
    return out
