"""Omega draws at global coordinates, the one-device sketch oracles, and
Alg. 1 (the sketch on a (p1, p2, p3) grid of torch.distributed ranks).

Entry values depend only on (seed, salt, global coordinate), never on the
tiling, so any shard regenerates exactly the block it consumes.  On the
card the dense kinds are drawn by the gen-Omega CUDA kernel
(``kernels/csrc/sketch_kernels.cu``); on the CPU, and for the sparse kinds
(which have no kernel) on any device, by the plain Philox of ``rng.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from . import rng
from .kinds import DENSE_KINDS, SPARSE_KINDS, VALID_KINDS, validate_kind
from .rng import resolve_device
from repro_torch.roofline import counts as _counts

__all__ = ["DENSE_KINDS", "SPARSE_KINDS", "VALID_KINDS", "validate_kind",
           "resolve_device", "seed_keys", "omega_tile", "sparse_omega_map",
           "sparse_omega_rows", "sketch_sparse_apply", "sketch_reference",
           "GridGroups", "make_grid_groups", "input_block", "output_block",
           "gather_output", "rand_matmul", "rand_matmul_auto",
           "rand_matmul_communicating"]


def seed_keys(seed):
    """The Philox (key0, key1) pair of a seed, as two ints in [0, 2**32).

    ``seed`` may be a Python int (split into its low and high uint32
    halves), a shape-(2,) key pair, or a 0-d array/tensor ``s`` (which
    gives ``(s, 0)``, not a split, as in the reference).
    """
    if isinstance(seed, (int, np.integer)):
        seed = int(seed)
        return seed & rng.MASK32, (seed >> 32) & rng.MASK32
    arr = (seed.detach().cpu().numpy() if isinstance(seed, torch.Tensor)
           else np.asarray(seed))
    if arr.shape == (2,):
        return int(arr[0]) & rng.MASK32, int(arr[1]) & rng.MASK32
    if arr.shape == ():
        return int(arr) & rng.MASK32, 0
    raise ValueError(f"seed must be an int, a scalar, or a (2,) key pair; "
                     f"got shape {arr.shape}")


def _omega_tile_torch(key0: int, key1: int, row0, col0, rows: int,
                      cols: int, kind: str, salt: int,
                      r_total: Optional[int], n_total: Optional[int],
                      device) -> torch.Tensor:
    """The plain float32 tile (the gen-Omega kernel's reference)."""
    if kind == "normal":
        return rng.philox_normal_grid(key0, key1, row0, col0, rows, cols,
                                      salt, device)
    if kind in ("uniform", "rademacher"):
        u = rng.philox_uniform_grid(key0, key1, row0, col0, rows, cols,
                                    salt, device)
        if kind == "uniform":
            return u
        one = torch.ones((), dtype=torch.float32, device=device)
        return torch.where(u < 0.5, -one, one)
    r_total = cols if r_total is None else r_total
    if kind == "countsketch":
        return rng.philox_countsketch_grid(key0, key1, row0, col0, rows,
                                           cols, r_total, salt, device)
    return rng.philox_rowsample_grid(
        key0, key1, row0, col0, rows, cols, r_total,
        rows if n_total is None else n_total, salt, device)


def _omega_work(seed, row0, col0, rows, cols, kind="normal",
                dtype=torch.float32, *_, **__):
    """A dense kind's tile is K8's work; a sparse kind's is torch ops."""
    return (_counts.gen_omega_work(rows, cols, dtype)
            if kind in DENSE_KINDS else None)


@_counts.kernel("gen_omega", _omega_work)
def omega_tile(seed, row0, col0, rows: int, cols: int,
               kind: str = "normal", dtype=torch.float32, salt: int = 0,
               r_total: Optional[int] = None, n_total: Optional[int] = None,
               device=None) -> torch.Tensor:
    """Tile [row0:row0+rows, col0:col0+cols] of the global Omega.

    ``r_total``/``n_total`` are the global column/row counts the sparse
    kinds need (defaults: a full-width, full-height tile); dense kinds
    ignore them.  ``device=None`` means the card.
    """
    validate_kind(kind)
    device = resolve_device(device)
    key0, key1 = seed_keys(seed)
    if kind in DENSE_KINDS and device.type == "cuda":
        from repro_torch.kernels.sketch_matmul import gen_omega_cuda
        t = gen_omega_cuda(key0, key1, int(row0), int(col0), rows, cols,
                           kind, salt, device=device)
    else:
        t = _omega_tile_torch(key0, key1, int(row0), int(col0), rows, cols,
                              kind, salt, r_total, n_total, device)
    return t.to(dtype)


def sparse_omega_map(seed, n_rows: int, width: int, kind: str,
                     dtype=torch.float32, salt: int = 0, row0=0,
                     n_total: Optional[int] = None, device=None):
    """Per-row (bucket, value) of a sparse Omega row range:
    ``Omega[row0 + i, bucket[i]] = value[i]`` (value 0: row not sampled).
    ``width`` is Omega's global column count, ``n_total`` its global row
    count (default ``n_rows``)."""
    validate_kind(kind)
    if kind not in SPARSE_KINDS:
        raise ValueError(f"kind {kind!r} is dense; sparse_omega_map serves "
                         f"{', '.join(SPARSE_KINDS)}")
    device = resolve_device(device)
    g = (int(row0) + torch.arange(n_rows, device=device)) & rng.MASK32
    return sparse_omega_rows(seed, g, width, kind, dtype, salt,
                             n_rows if n_total is None else n_total)


def sparse_omega_rows(seed, g, width: int, kind: str, dtype=torch.float32,
                      salt: int = 0, n_total: Optional[int] = None):
    """(bucket, value) draws at a tensor ``g`` of global row indices (any
    repetition); draws depend only on ``g[i]``, so gathering per stored
    entry is bitwise the slice of the full map.  Follows ``g``'s device."""
    validate_kind(kind)
    if kind not in SPARSE_KINDS:
        raise ValueError(f"kind {kind!r} is dense; sparse_omega_rows serves "
                         f"{', '.join(SPARSE_KINDS)}")
    key0, key1 = seed_keys(seed)
    g = torch.as_tensor(g).to(torch.int64) & rng.MASK32
    bucket, sign = rng.philox_countsketch_rows(key0, key1, g, width, salt)
    if kind == "countsketch":
        value = sign
    else:
        if n_total is None:
            raise ValueError("rowsample draws need n_total (global rows)")
        value = rng._rowsample_values(key0, key1, g, sign, width, n_total,
                                      salt)
    return bucket, value.to(dtype)


def sketch_sparse_apply(A: torch.Tensor, seed, r: int,
                        kind: str = "countsketch",
                        salt: int = 0) -> torch.Tensor:
    """B = A @ Omega for a sparse Omega without materializing it: one
    scatter-add (``index_add_``) per stored entry of A.  Equal to the
    dense product up to summation order."""
    validate_kind(kind)
    if kind not in SPARSE_KINDS:
        raise ValueError(f"kind {kind!r} is dense; use sketch_reference")
    n2 = A.shape[-1]
    bucket, value = sparse_omega_map(seed, n2, r, kind, A.dtype, salt,
                                     device=A.device)
    out = torch.zeros((*A.shape[:-1], r), dtype=A.dtype, device=A.device)
    return out.index_add_(-1, bucket, A * value)


def sketch_reference(A: torch.Tensor, seed, r: int, kind: str = "normal",
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-device oracle: B = A @ Omega with the full Omega materialized."""
    validate_kind(kind)
    om = omega_tile(seed, 0, 0, A.shape[-1], r, kind, A.dtype,
                    device=A.device)
    if scale is not None:
        om = om * torch.tensor(scale, dtype=A.dtype, device=A.device)
    return A @ om


# ---------------------------------------------------------------------------
# The processor grid on torch.distributed
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GridGroups:
    """This rank's place on a (p1, p2, p3) grid and its fiber groups.

    Grid rank ``(i·p2 + j)·p3 + k`` is process rank ``order[(i·p2 + j)·p3
    + k]``; ``order`` None is the row-major map, process rank ``(i·p2 +
    j)·p3 + k`` (the reference's ``np.reshape(devices[:P], (p1, p2,
    p3))``).  ``coords`` is None on a rank past the grid, which holds no
    block.  ``p1_group`` joins the ranks that differ only in i (None when
    p1 == 1), ``p2_group`` those that differ only in j (None when
    p2 == 1), ``p3_group`` those that differ only in k (None when
    p3 == 1), ``grid_group`` the grid's P ranks (None when it is the whole
    world: the default group)."""
    shape: Tuple[int, int, int]
    rank: int
    coords: Optional[Tuple[int, int, int]]
    p2_group: Any = None
    p3_group: Any = None
    grid_group: Any = None
    p1_group: Any = None
    order: Optional[Tuple[int, ...]] = None

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1] * self.shape[2]

    def coords_of(self, rank: int) -> Tuple[int, int, int]:
        """The grid coordinates of process ``rank`` (one of the grid's)."""
        flat = rank if self.order is None else self.order.index(rank)
        _, p2, p3 = self.shape
        return flat // (p2 * p3), flat // p3 % p2, flat % p3


_GRID_GROUPS: dict = {}


def make_grid_groups(p1: int, p2: int, p3: int,
                     order: Optional[Tuple[int, ...]] = None) -> GridGroups:
    """This rank's :class:`GridGroups` of a (p1, p2, p3) grid over the
    first p1·p2·p3 ranks of the default process group (the counterpart of
    ``make_grid_mesh``).  ``order`` lists the process rank at each grid
    rank, row-major (default: ``range(P)``); a permuted grid keeps every
    fiber in increasing rank order, which is the order gloo gives a
    group's members.

    Every rank of the world must call it with the same shapes in the same
    order: ``torch.distributed.new_group`` is collective over the world,
    and every rank creates every fiber's group, in (i, k) order for the
    p2 fibers, then (i, j) order for the p3 fibers, then (j, k) order for
    the p1 fibers.  The result is cached per shape and order for the life
    of the default group."""
    import torch.distributed as dist
    shape = (int(p1), int(p2), int(p3))
    P = math.prod(shape)
    if order is not None:
        order = tuple(int(x) for x in order)
        if sorted(order) != list(range(P)):
            raise ValueError(f"order {order} is not a permutation of the "
                             f"grid's {P} ranks")
        if order == tuple(range(P)):
            order = None
    key = (shape, order)
    world = dist.group.WORLD
    cached = _GRID_GROUPS.get(key)
    if cached is not None and cached[0] is world:
        return cached[1]
    nworld, rank = dist.get_world_size(), dist.get_rank()
    if P > nworld:
        raise ValueError(f"grid {p1}x{p2}x{p3} needs {P} devices, have "
                         f"{nworld}")

    def proc(i, j, k):
        flat = (i * p2 + j) * p3 + k
        return flat if order is None else order[flat]

    fibers = ([("p2", [proc(i, j, k) for j in range(p2)])
               for i in range(p1) for k in range(p3)] if p2 > 1 else [])
    fibers += ([("p3", [proc(i, j, k) for k in range(p3)])
                for i in range(p1) for j in range(p2)] if p3 > 1 else [])
    fibers += ([("p1", [proc(i, j, k) for i in range(p1)])
                for j in range(p2) for k in range(p3)] if p1 > 1 else [])
    for axis, ranks in fibers:
        if ranks != sorted(ranks):
            raise ValueError(f"order {order}: a {axis} fiber {ranks} is not "
                             f"in increasing rank order")
    mine = {}
    for axis, ranks in fibers:
        group = dist.new_group(ranks)
        if rank in ranks:
            mine[axis] = group
    grid = dist.new_group(list(range(P))) if P < nworld else None
    g = GridGroups(shape, rank, None, mine.get("p2"), mine.get("p3"),
                   grid if rank < P else None, mine.get("p1"), order)
    if rank < P:
        g = dataclasses.replace(g, coords=g.coords_of(rank))
    _GRID_GROUPS[key] = (world, g)
    return g


def _not_divisible(n1: int, n2: int, r: int, shape) -> ValueError:
    p1, p2, p3 = shape
    return ValueError(f"shape ({n1},{n2},r={r}) not divisible by grid "
                      f"({p1},{p2},{p3})")


def input_block(A: torch.Tensor, g: GridGroups) -> Optional[torch.Tensor]:
    """This rank's block of A in Alg. 1's input layout P(p1, (p2, p3)):
    rows ``i·n1/p1``, columns ``(j·p3 + k)·n2/(p2·p3)``, contiguous (None
    past the grid)."""
    p1, p2, p3 = g.shape
    n1, n2 = A.shape
    if n1 % p1 or n2 % (p2 * p3):
        raise ValueError(f"A of shape ({n1},{n2}) not divisible by grid "
                         f"({p1},{p2},{p3})")
    if g.coords is None:
        return None
    i, j, k = g.coords
    rows, cols = n1 // p1, n2 // (p2 * p3)
    c0 = (j * p3 + k) * cols
    return A[i * rows:(i + 1) * rows, c0:c0 + cols].contiguous()


def output_block(B: torch.Tensor, g: GridGroups) -> Optional[torch.Tensor]:
    """This rank's block of B in Alg. 1's output layout P((p1, p2), p3):
    rows ``(i·p2 + j)·n1/(p1·p2)``, columns ``k·r/p3`` (a view; None past
    the grid)."""
    p1, p2, p3 = g.shape
    n1, r = B.shape
    if n1 % (p1 * p2) or r % p3:
        raise ValueError(f"B of shape ({n1},{r}) not divisible by grid "
                         f"({p1},{p2},{p3})")
    if g.coords is None:
        return None
    i, j, k = g.coords
    rows, cols = n1 // (p1 * p2), r // p3
    r0 = (i * p2 + j) * rows
    return B[r0:r0 + rows, k * cols:(k + 1) * cols]


def grid_ordered(blocks: torch.Tensor, g: GridGroups) -> torch.Tensor:
    """Blocks stacked by process rank (``gather_blocks``) restacked by
    grid rank (row-major coordinates)."""
    return blocks if g.order is None else blocks[list(g.order)]


def gather_output(B_blk: Optional[torch.Tensor],
                  g: GridGroups) -> Optional[torch.Tensor]:
    """The full B from every grid rank's output block (for tests and
    checks; its words are not counted).  None past the grid."""
    if g.coords is None:
        return None
    from repro_torch.parallel.collectives import gather_blocks
    p1, p2, p3 = g.shape
    rows, cols = B_blk.shape
    blocks = grid_ordered(gather_blocks(B_blk, g.grid_group, g.size), g)
    return (blocks.view(p1 * p2, p3, rows, cols).permute(0, 2, 1, 3)
            .reshape(p1 * p2 * rows, p3 * cols))


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------

def _dense_only(kind: str) -> None:
    validate_kind(kind)
    if kind in SPARSE_KINDS:
        raise NotImplementedError(
            f"kind {kind!r}: distributed sparse bodies are deferred, as in "
            f"the reference — use sketch_sparse_apply or a local "
            f"StreamingSketch / SketchService for sparse kinds, or a dense "
            f"kind here")


def rand_matmul(A_blk: Optional[torch.Tensor], seed, r: int, g: GridGroups,
                kind: str = "normal", scale: Optional[float] = None,
                salt: int = 0) -> Optional[torch.Tensor]:
    """B = A @ Omega on the grid ``g`` (paper Alg. 1), from this rank's
    block ``A_blk = input_block(A, g)``; returns this rank's block of B,
    ``output_block(B, g)`` (None past the grid).

    One tiled all-gather of A over the p3 fiber (none when p3 == 1), the
    local ``sketch_block`` over Omega's (n2/p2 x r/p3) block drawn at its
    global offsets (on the card the ``sketch_fwd`` kernel; no Omega word
    moves), one tiled reduce-scatter of B over the p2 fiber (none when
    p2 == 1): ``(1-1/p3)·n1n2/(p1p2) + (1-1/p2)·n1r/(p1p3)`` words
    received, ``parallel.collectives.COMM``.  Runs where ``A_blk`` lies."""
    _dense_only(kind)
    if g.coords is None:
        return None
    from repro_torch.kernels.local import sketch_block
    from repro_torch.parallel.collectives import all_gather, reduce_scatter
    p1, p2, p3 = g.shape
    rows, cols = A_blk.shape
    n1, n2 = rows * p1, cols * p2 * p3
    # rows % p2: B is laid out P((p1, p2), p3), so the reduce-scatter
    # splits each n1/p1 row block p2 ways
    if rows % p2 or r % p3:
        raise _not_divisible(n1, n2, r, g.shape)
    _, j, k = g.coords
    a_ij = all_gather(A_blk, 1, g.p3_group, p3)
    blk_rows, blk_cols = n2 // p2, r // p3
    b_partial = sketch_block(a_ij, seed, blk_cols, row0=j * blk_rows,
                             col0=k * blk_cols, kind=kind, salt=salt,
                             scale=scale)
    return reduce_scatter(b_partial, g.p2_group, p2)


def rand_matmul_auto(A: torch.Tensor, seed, r: int,
                     P_procs: Optional[int] = None, kind: str = "normal",
                     grid="auto", plan=None):
    """Alg. 1 with the grid chosen automatically, from the full A that
    every rank holds.

    grid:
      * ``"auto"`` — the paper's §4.3 grid (``select_matmul_grid``), or,
        when it does not divide the shape, the factorization of P that
        does with the fewest words (``_best_executable_alg1_grid``);
      * ``"plan"`` — the cost model's choice (``plan.plan_sketch``; the
        same as passing ``plan=plan_sketch(n1, n2, r, P=P_procs)``);
      * an explicit ``(p1, p2, p3)`` tuple.
    plan: a :class:`repro_torch.plan.Plan` (wins over ``grid``): an
    ``alg1`` plan runs on its grid, a ``local_torch`` plan on (1, 1, 1);
    a ``cuda_fused`` plan is no grid program (call ``plan.execute``).
    ``P_procs`` defaults to the world size.  Returns ``(B_blk,
    MatmulGrid, GridGroups)``."""
    import torch.distributed as dist

    from repro_torch.plan.planner import (Plan, _alg1_executable,
                                          _best_executable_alg1_grid,
                                          plan_sketch)
    from .grid import MatmulGrid, alg1_bandwidth_words, alg1_latency_hops
    from .lower_bounds import matmul_regime
    _dense_only(kind)
    P_procs = P_procs or dist.get_world_size()
    n1, n2 = A.shape
    if plan is not None or grid == "plan":
        if plan is None:
            plan = plan_sketch(n1, n2, r, P=P_procs, kind=kind)
        if not isinstance(plan, Plan):
            raise TypeError(f"plan must be a repro_torch.plan.Plan "
                            f"(plan_sketch); got {plan!r}")
        if not plan.executable:
            raise ValueError(
                f"plan {plan.variant!r} for dims={plan.dims}, "
                f"P={plan.n_procs} is analytic-only (no executable grid "
                f"divides the shape)")
        if plan.variant == "alg1" and plan.grid is not None:
            grid = plan.grid
        elif plan.variant == "local_torch":
            grid = (1, 1, 1)          # the degenerate Alg.-1 grid
        else:
            raise ValueError(f"plan variant {plan.variant!r} is not an "
                             f"Alg.-1 grid plan; call plan.execute instead")
    if grid == "auto":
        shape = _best_executable_alg1_grid(n1, n2, r, P_procs)
        if shape is None:
            raise ValueError(f"no factorization of P={P_procs} divides "
                             f"({n1}, {n2}, r={r}); pad the shape or "
                             f"change P")
    else:
        shape = tuple(grid)
        if not _alg1_executable(n1, n2, r, shape):
            raise _not_divisible(n1, n2, r, shape)
    gm = MatmulGrid(*shape, matmul_regime(n1, n2, r, P_procs),
                    alg1_bandwidth_words(n1, n2, r, *shape),
                    alg1_latency_hops(shape[1], shape[2]))
    g = make_grid_groups(*gm.shape)
    return rand_matmul(input_block(A, g), seed, r, g, kind=kind), gm, g


def rand_matmul_communicating(A_blk: Optional[torch.Tensor], seed, r: int,
                              g: GridGroups, kind: str = "normal"
                              ) -> Optional[torch.Tensor]:
    """The baseline that COMMUNICATES Omega (paper Fig. 3's losing
    strategy): each grid rank draws its n2/P rows of Omega (the one copy
    in the system; on the card the ``gen_omega`` kernel), every rank
    all-gathers the whole Omega over the grid, slices its (j, k) block
    and multiplies with ``torch.matmul`` (the reference's plain
    ``a_ij @ om``), then reduce-scatters over p2 as Alg. 1 does.  Same B,
    strictly more words received."""
    _dense_only(kind)
    if g.coords is None:
        return None
    from repro_torch.parallel.collectives import all_gather, reduce_scatter
    p1, p2, p3 = g.shape
    rows, cols = A_blk.shape
    n1, n2, P = rows * p1, cols * p2 * p3, g.size
    if rows % p2 or r % p3 or n2 % P:
        raise _not_divisible(n1, n2, r, g.shape)
    _, j, k = g.coords
    own = n2 // P
    om_blk = omega_tile(seed, g.rank * own, 0, own, r, kind, A_blk.dtype,
                        device=A_blk.device)
    a_ij = all_gather(A_blk, 1, g.p3_group, p3)
    om_full = all_gather(om_blk, 0, g.grid_group, P)
    blk_rows, blk_cols = n2 // p2, r // p3
    om = om_full[j * blk_rows:(j + 1) * blk_rows,
                 k * blk_cols:(k + 1) * blk_cols]
    return reduce_scatter(a_ij @ om, g.p2_group, p2)
