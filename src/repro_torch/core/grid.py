"""Optimal processor-grid selection (paper §4.3 and §5.3) + cost models.

``select_matmul_grid``   — the paper's per-regime optimal (p1, p2, p3) for
                           Algorithm 1, exact when divisibility allows, else
                           snapped to the nearest feasible factorization.
``select_nystrom_grids`` — §5.3's two approaches: ``redist`` (bound-driven
                           grids, B re-laid out with an all-to-all) and
                           ``no_redist`` (q == p, pays an O(r^2)
                           reduce-scatter instead).
``alg1_bandwidth_words`` / ``alg2_bandwidth_words`` — the paper's closed-form
costs for the chosen grids; tests assert alg-cost == lower bound in every
regime of Theorem 2 (tightness), and within the paper's stated gap for
Theorem 3.

The port's copy of ``repro.core.grid`` (pure ``math``; importing
``repro.core`` pulls in jax).  ``two_grid_shared_mesh`` builds a JAX mesh
in the reference; here it gives the same axis groups over one row-major
order of process ranks, and holds no mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Optional, Tuple

from .lower_bounds import matmul_regime, nystrom_regime


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _divisors(P: int) -> list:
    out = []
    i = 1
    while i * i <= P:
        if P % i == 0:
            out.append(i)
            if i != P // i:
                out.append(P // i)
        i += 1
    return sorted(out)


def factorizations_3d(P: int) -> Iterable[Tuple[int, int, int]]:
    """All (p1, p2, p3) with p1*p2*p3 == P."""
    for p1 in _divisors(P):
        rem = P // p1
        for p2 in _divisors(rem):
            yield (p1, p2, rem // p2)


def alg1_bandwidth_words(n1: int, n2: int, r: int,
                         p1: int, p2: int, p3: int) -> float:
    """Algorithm 1 bandwidth cost (paper §4.2.1):

        (1 - 1/p3) * n1*n2/(p1*p2)   [All-Gather of A over Pi_ij*]
      + (1 - 1/p2) * n1*r/(p1*p3)    [Reduce-Scatter of B over Pi_i*k]
    """
    P = p1 * p2 * p3
    ag = (1.0 - 1.0 / p3) * (n1 * n2) / (p1 * p2)
    rs = (1.0 - 1.0 / p2) * (n1 * r) / (p1 * p3)
    assert P > 0
    return ag + rs


def alg1_latency_hops(p2: int, p3: int) -> float:
    """log(p3) + log(p2) messages on the critical path (§4.2.1)."""
    return math.log2(max(p3, 1)) + math.log2(max(p2, 1))


# ---------------------------------------------------------------------------
# §4.3 — optimal grid for Algorithm 1
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MatmulGrid:
    p1: int
    p2: int
    p3: int
    regime: int
    bandwidth_words: float
    latency_hops: float

    @property
    def shape(self):
        return (self.p1, self.p2, self.p3)


def select_matmul_grid(n1: int, n2: int, r: int, P: int,
                       exhaustive_fallback: bool = True) -> MatmulGrid:
    """The paper's optimal grid, snapped to integer factorizations of P.

    Case 1 (P <= n1):        (P, 1, 1)          -> zero communication
    Case 2 (n1 < P <= n1n2/r):(n1, P/n1, 1)
    Case 3 (else):           (n1, sqrt(Pn2/(r n1)), sqrt(Pr/(n1 n2)))

    When the paper's ideal dims don't divide P (or exceed matrix dims), we
    pick the factorization of P minimizing the Alg. 1 cost model, restricted
    to p1 <= n1, p2 <= n2, p3 <= r — this is exactly what a production
    launcher must do on a fixed mesh.
    """
    regime = matmul_regime(n1, n2, r, P)
    ideal: Tuple[int, int, int]
    if regime == 1:
        ideal = (P, 1, 1)
    elif regime == 2:
        ideal = (n1, max(1, P // n1), 1)
    else:
        p2 = math.sqrt(P * n2 / (r * n1))
        p3 = math.sqrt(P * r / (n1 * n2))
        ideal = (n1, max(1, round(p2)), max(1, round(p3)))

    p1, p2, p3 = ideal
    if p1 * p2 * p3 == P and p1 <= n1 and p2 <= n2 and p3 <= r:
        return MatmulGrid(p1, p2, p3, regime,
                          alg1_bandwidth_words(n1, n2, r, p1, p2, p3),
                          alg1_latency_hops(p2, p3))

    if not exhaustive_fallback:
        raise ValueError(f"ideal grid {ideal} infeasible for P={P}")

    best = None
    for (a, b, c) in factorizations_3d(P):
        if a > n1 or b > n2 or c > r:
            continue
        cost = alg1_bandwidth_words(n1, n2, r, a, b, c)
        key = (cost, alg1_latency_hops(b, c))
        if best is None or key < best[0]:
            best = (key, (a, b, c))
    if best is None:
        # degenerate matrices; fall back to 1D over rows
        a = min(P, n1)
        return MatmulGrid(a, 1, 1, regime,
                          alg1_bandwidth_words(n1, n2, r, a, 1, 1),
                          0.0)
    (cost, lat), (a, b, c) = best
    return MatmulGrid(a, b, c, regime, cost, lat)


# ---------------------------------------------------------------------------
# §5.3 — Nystrom grids
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NystromGrids:
    p: Tuple[int, int, int]
    q: Tuple[int, int, int]
    variant: str           # "redist" | "no_redist" | "bound_driven"
    regime: int
    bandwidth_words: float
    redistributes_B: bool


def alg2_bandwidth_words(n: int, r: int,
                         p: Tuple[int, int, int],
                         q: Tuple[int, int, int]) -> float:
    """Algorithm 2 bandwidth cost (§5.2.1), including redistribution.

        (1-1/p3) n^2/(p1 p2)   AG of A
      + (1-1/p2) nr/(p1 p3)    RS of B-hat
      + (1-1/q2) nr/(q1 q3)    AG of B
      + (1-1/q1) r^2/(q2 q3)   RS of C
      + nr/P if p != q         all-to-all redistribution of B
    """
    p1, p2, p3 = p
    q1, q2, q3 = q
    P = p1 * p2 * p3
    cost = ((1 - 1 / p3) * n * n / (p1 * p2)
            + (1 - 1 / p2) * n * r / (p1 * p3)
            + (1 - 1 / q2) * n * r / (q1 * q3)
            + (1 - 1 / q1) * r * r / (q2 * q3))
    if tuple(p) != tuple(q):
        cost += n * r / P
    return cost


def select_nystrom_grids(n: int, r: int, P: int,
                         variant: str = "auto") -> NystromGrids:
    """§5.3 grid selection.

    variant:
      * ``redist``     — 1D Case-1 grids p=(P,1,1), q=(1,1,P); all-to-all
                         re-layout of B; comm O(nr/P). Scales with P.
      * ``no_redist``  — p=q=(P,1,1); B never moves; comm O(r^2) from the
                         C reduce-scatter. Better when P < n/r.
      * ``bound_driven``— the per-regime grids of §5.3 approach 1.
      * ``auto``       — paper's empirical rule: redist iff P > n/r.
    """
    regime = nystrom_regime(n, r, P)
    if variant == "auto":
        variant = "redist" if P > max(1, n // max(r, 1)) else "no_redist"

    if variant == "no_redist":
        p = q = (min(P, n), 1, 1)
        if p[0] != P:
            p = q = _snap_1d(n, P)
        return NystromGrids(p, q, "no_redist", regime,
                            alg2_bandwidth_words(n, r, p, q), False)

    if variant == "redist":
        p = (min(P, n), 1, 1)
        q = (1, 1, min(P, r)) if P <= r else _snap_q_redist(n, r, P)
        if p[0] != P:
            p = _snap_1d(n, P)
        return NystromGrids(p, q, "redist", regime,
                            alg2_bandwidth_words(n, r, p, q), True)

    if variant == "bound_driven":
        if regime == 1:
            p, q = (P, 1, 1), (1, 1, P)
        elif regime == 2:
            p, q = (P, 1, 1), (max(1, P // r), 1, min(r, P))
        elif regime == 3:
            p = (min(n, P), max(1, P // n), 1)
            q = (max(1, n // r), max(1, P // n), min(r, P))
            p, q = _fix_product(p, P), _fix_product(q, P)
        else:
            p2 = max(1, round(math.sqrt((n + r) * P / (n * r))))
            p3 = max(1, P // (min(n, P) * p2))
            p = _fix_product((min(n, P), p2, p3), P)
            q = _fix_product((max(1, P // (p2 * min(r, P))), p2, min(r, P)), P)
        return NystromGrids(tuple(p), tuple(q), "bound_driven", regime,
                            alg2_bandwidth_words(n, r, p, q),
                            tuple(p) != tuple(q))

    raise ValueError(f"unknown variant {variant!r}")


def alg2_two_grid_executable(n: int, r: int,
                             p: Tuple[int, int, int],
                             q: Tuple[int, int, int]) -> bool:
    """Whether ``core.nystrom.nystrom_two_grid`` can run (p, q) on (n, r).

    Stage 1 is Alg. 1 with n1 = n2 = n, so it inherits the entry point's
    divisibility contract (the B layout P((p1, p2), p3) reduce-scatters each
    n/p1 row block p2 ways).  Stage 2 lays B out P(q1, (q3, q2)) and
    reduce-scatters each r/q2 row block of C q1 ways, hence r % (q1*q2).
    """
    p1, p2, p3 = p
    q1, q2, q3 = q
    stage1 = (n % (p1 * p2) == 0 and n % (p2 * p3) == 0 and r % p3 == 0
              and p1 <= n and p2 <= n and p3 <= r)
    stage2 = (n % q1 == 0 and r % (q1 * q2) == 0 and r % (q2 * q3) == 0
              and q1 <= n and q2 <= r and q3 <= r)
    return stage1 and stage2


def select_two_grid_executable(n: int, r: int, P: int, p=None):
    """The §5.3 bound-driven (p, q) pair, snapped to what can execute.

    Returns ``(p, q, exact)`` where ``exact`` says the ideal bound-driven
    grids themselves divide (n, r); otherwise (p, q) is the pair of
    factorizations of P minimizing ``alg2_bandwidth_words`` among all
    executable pairs (the same min-words snap ``grid="auto"`` applies to
    Alg. 1), and the caller should report the bound gap.  Returns ``None``
    when no factorization pair divides the shape.  ``p`` fixes the stage-1
    grid (e.g. a streamed accumulator already laid out on (P, 1, 1)) and
    restricts the search to q.
    """
    ideal = select_nystrom_grids(n, r, P, variant="bound_driven")
    if (p is None or tuple(p) == tuple(ideal.p)) \
            and alg2_two_grid_executable(n, r, ideal.p, ideal.q):
        return tuple(ideal.p), tuple(ideal.q), True
    facs = list(factorizations_3d(P))
    p_cands = [tuple(p)] if p is not None else facs
    best = None
    for pc in p_cands:
        for qc in facs:
            if not alg2_two_grid_executable(n, r, pc, qc):
                continue
            w = alg2_bandwidth_words(n, r, pc, qc)
            lat = (alg1_latency_hops(pc[1], pc[2])
                   + math.log2(max(qc[0], 1))
                   + (math.log2(max(P, 1)) if pc != qc else 0.0))
            key = (w, lat)
            if best is None or key < best[0]:
                best = (key, pc, qc)
    if best is None:
        return None
    return best[1], best[2], False


# ---------------------------------------------------------------------------
# §5.2 Redistribute, in-program: device-order reconciliation of two grids.
#
# When one row-major device order refines both factorizations of P, the
# device at p-coordinate (i, j, k) and the device at q-coordinate
# (i', j', k') are the same physical assignment the two separate grids
# would use, and the Redistribute of B between them can run inside one
# program.  ``two_grid_axis_split`` computes that refinement.
# ---------------------------------------------------------------------------

def two_grid_axis_split(p: Tuple[int, int, int],
                        q: Tuple[int, int, int]):
    """Common row-major refinement of two factorizations of the same P.

    Returns ``(sizes, p_groups, q_groups)`` — mesh axis sizes plus, per
    grid, three tuples of axis indices whose size products are the grid
    dims — or ``None`` when no single row-major device assignment serves
    both grids (the prefix products of p and q do not chain under
    divisibility, e.g. p=(2,3,1) vs q=(3,2,1) over P=6).
    """
    p = tuple(int(x) for x in p)
    q = tuple(int(x) for x in q)
    P = p[0] * p[1] * p[2]
    if q[0] * q[1] * q[2] != P:
        raise ValueError(f"grids must factor the same P: {p} vs {q}")
    if P == 1:
        return (1,), ((0,), (), ()), ((0,), (), ())
    cuts = sorted({1, P, p[0], p[0] * p[1], q[0], q[0] * q[1]})
    for a, b in zip(cuts, cuts[1:]):
        if b % a:
            return None
    sizes = tuple(b // a for a, b in zip(cuts, cuts[1:]))

    def groups(g):
        bounds = (1, g[0], g[0] * g[1], P)
        return tuple(
            tuple(i for i, (a, b) in enumerate(zip(cuts, cuts[1:]))
                  if a >= bounds[bi] and b <= bounds[bi + 1])
            for bi in range(3))

    return sizes, groups(p), groups(q)


@dataclass(frozen=True)
class TwoGridSharedMesh:
    """One rank order serving both grids of a two-grid Alg. 2 run.

    ``sizes`` are the axes of the common row-major refinement, named
    ``g0, g1, ...``; ``p_axes`` / ``q_axes`` are 3-tuples of (possibly
    empty) tuples of those names whose size products are (p1, p2, p3) /
    (q1, q2, q3).  Grouped row-major over process ranks ``0 .. P-1``, they
    give each rank the coordinates ``make_grid_groups(*p)`` and
    ``make_grid_groups(*q)`` give it (the reference holds a jax ``Mesh``
    of these axes; the port holds none)."""
    sizes: Tuple[int, ...]
    p: Tuple[int, int, int]
    q: Tuple[int, int, int]
    p_axes: Tuple[Tuple[str, ...], Tuple[str, ...], Tuple[str, ...]]
    q_axes: Tuple[Tuple[str, ...], Tuple[str, ...], Tuple[str, ...]]


def two_grid_shared_mesh(p: Tuple[int, int, int],
                         q: Tuple[int, int, int],
                         world: Optional[int] = None):
    """The rank order that serves BOTH grids, or ``None``.

    ``None`` exactly where the reference's is: no single row-major
    assignment of ranks refines both factorizations
    (``two_grid_axis_split``).  ``world`` is the number of ranks there
    are (default: the default process group's size); a P above it raises
    the reference's ``ValueError``."""
    split = two_grid_axis_split(p, q)
    if split is None:
        return None
    sizes, pg, qg = split
    if world is None:
        import torch.distributed as dist
        world = dist.get_world_size()
    P = p[0] * p[1] * p[2]
    if world < P:
        raise ValueError(f"grids {p}/{q} need {P} devices, have {world}")
    names = tuple(f"g{i}" for i in range(len(sizes)))

    def to_names(idxs):
        return tuple(tuple(names[i] for i in grp) for grp in idxs)

    return TwoGridSharedMesh(sizes=sizes, p=tuple(p), q=tuple(q),
                             p_axes=to_names(pg), q_axes=to_names(qg))


def _snap_1d(n: int, P: int) -> Tuple[int, int, int]:
    """Largest p1 | P with p1 <= n, rest into p2."""
    for d in sorted(_divisors(P), reverse=True):
        if d <= n:
            return (d, P // d, 1)
    return (1, P, 1)


def _snap_q_redist(n: int, r: int, P: int) -> Tuple[int, int, int]:
    for d in sorted(_divisors(P), reverse=True):
        if d <= r:
            return (P // d, 1, d)
    return (P, 1, 1)


def _fix_product(p: Tuple[int, int, int], P: int) -> Tuple[int, int, int]:
    """Adjust a rounded grid so the product is exactly P (greedy)."""
    p1, p2, p3 = (max(1, int(x)) for x in p)
    prod = p1 * p2 * p3
    if prod == P:
        return (p1, p2, p3)
    # greedy: fix p1 to a divisor, then p2, then p3 absorbs the rest
    d1 = max(d for d in _divisors(P) if d <= max(p1, 1))
    rem = P // d1
    d2 = max(d for d in _divisors(rem) if d <= max(p2, 1))
    return (d1, d2, rem // d2)
