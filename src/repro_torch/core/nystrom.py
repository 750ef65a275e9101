"""Nystrom approximation (paper §5): the one-device oracle and the 1-D
Alg. 2 on torch.distributed.

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

The second stages take any row-sharded B and a ``salt``, so a streamed
accumulator can finalize through them.  On the card the first stage is
the ``sketch_fwd`` kernel and the second ``sketch_t``; the dense Omega is
never formed and never moves.  The distributed entry points run where the
caller's tensors lie.  The two-grid variants are not ported yet
(ROADMAP.md Queue 1, item 5b).
"""
from __future__ import annotations

from typing import Optional

import torch

from .sketch import (GridGroups, _dense_only, input_block, make_grid_groups,
                     omega_tile, validate_kind)


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
    """The 1-D Alg. 2 on the first ``P_procs`` ranks (default: the world),
    from the full A that every rank holds.

    variant:
      * ``"auto"`` — the paper's empirical rule: redist iff P > n/r;
      * ``"no_redist"`` / ``"redist"`` — explicit.
    Returns ``(B_blk, C_blk, GridGroups, variant)``: row blocks for
    no_redist, column blocks for redist (None past the grid)."""
    import torch.distributed as dist
    _dense_only(kind)
    if plan is not None or variant == "plan":
        raise NotImplementedError(
            "variant='plan' / plan= need plan_nystrom, which is not ported "
            "(ROADMAP.md Queue 1, item 7); pass variant='auto' or a 1-D "
            "variant")
    if variant == "bound_driven":
        raise NotImplementedError(
            "variant='bound_driven' needs the two-grid Alg. 2, which is not "
            "ported (ROADMAP.md Queue 1, item 5b); pass variant='auto' or a "
            "1-D variant")
    P = P_procs or dist.get_world_size()
    n = A.shape[0]
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
