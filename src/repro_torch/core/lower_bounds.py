"""Communication lower bounds from the paper (Theorems 2 and 3).

Closed forms for:
  * ``matmul_lower_bound``  — Theorem 2: B = A·Omega, A: n1 x n2, Omega: n2 x r
    random (regenerable), r < n2.  Three regimes in P.
  * ``nystrom_lower_bound`` — Theorem 3: B = A·Omega then C = Omega^T·B,
    A: n x n, Omega: n x r random, r < n.  Four regimes in P.
  * ``gemm_lower_bound``    — the classical non-random GEMM bound
    [Al Daas et al., SPAA'22] used by the paper as the comparison point
    ("random input needs strictly less communication").

Each closed form is paired with a *numeric* optimizer
(``minimize_access_matmul`` / ``minimize_access_nystrom``) that solves the
paper's constrained optimization (Lemma 5 / Lemma 6) directly; the property
tests assert closed-form == numeric optimum across the whole (n, r, P) space,
which is an executable re-proof of the KKT case analysis.

All returns are in *words* (element counts), matching the paper's model.
Pure ``math``: the port keeps its own copy of ``repro.core.lower_bounds``,
since importing ``repro.core`` pulls in jax; the two return equal values
(``tests/test_torch_grid.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


# ---------------------------------------------------------------------------
# Theorem 2 — B = A * Omega
# ---------------------------------------------------------------------------

def matmul_regime(n1: int, n2: int, r: int, P: int) -> int:
    """Which case of Theorem 2 applies (1, 2, or 3)."""
    if P <= n1:
        return 1
    if P <= n1 * n2 / r:
        return 2
    return 3


def matmul_access_lower_bound(n1: int, n2: int, r: int, P: int) -> float:
    """Lemma 5 optimum: min words a 1/P-load processor must *access*."""
    case = matmul_regime(n1, n2, r, P)
    if case == 1:
        return n1 * n2 / P + n1 * r / P
    if case == 2:
        return n1 * n2 / P + r
    return 2.0 * math.sqrt(n1 * n2 * r / P)


def matmul_lower_bound(n1: int, n2: int, r: int, P: int) -> float:
    """Theorem 2: minimum words *communicated* by some processor.

    W = (min access) - (data the processor may own) with ownership
    (n1*n2 + n1*r)/P under the one-copy input/output assumption.
    """
    if not (r < n2):
        raise ValueError(f"paper assumes r < n2, got r={r}, n2={n2}")
    own = (n1 * n2 + n1 * r) / P
    W = matmul_access_lower_bound(n1, n2, r, P) - own
    return max(0.0, W)


def gemm_lower_bound(n1: int, n2: int, n3: int, P: int) -> float:
    """Classical memory-independent GEMM bound (both operands must move).

    From Al Daas et al. SPAA'22 (paper's ref [4]); used for the
    "sketching needs less communication than GEMM" comparison.  Three
    regimes for n1 >= n2 >= n3 (we sort dims to canonical order):
        P <= n1/n2              : (n2 n3) - lower-order
        n1/n2 < P <= n1 n2/n3^2 : 2 (n1 n2 n3 / P)^(1/2) ... (2D regime)
        else                    : 3 (n1 n2 n3 / P)^(2/3) / ... (3D regime)
    We implement the standard access form and subtract ownership.
    """
    d = sorted((n1, n2, n3), reverse=True)
    m1, m2, m3 = d  # m1 >= m2 >= m3
    own = (n1 * n2 + n2 * n3 + n1 * n3) / P
    if P <= m1 / m2:
        access = m2 * m3 + (m1 * m2 + m1 * m3) / P
    elif P <= m1 * m2 / (m3 * m3):
        access = 2.0 * math.sqrt(m1 * m2 * m3 * m3 / P) + m1 * m2 / P
    else:
        access = 3.0 * (m1 * m2 * m3 / P) ** (2.0 / 3.0)
    return max(0.0, access - own)


# ---------------------------------------------------------------------------
# Theorem 3 — Nystrom pair B = A*Omega ; C = Omega^T*B
# ---------------------------------------------------------------------------

def nystrom_regime(n: int, r: int, P: int) -> int:
    """Which case of Theorem 3 / Lemma 6 applies (1..4)."""
    if P <= r:
        return 1
    if P <= n:
        return 2
    if P <= n * (n + r) / r:
        return 3
    return 4


def nystrom_access_lower_bound(n: int, r: int, P: int) -> float:
    """Lemma 6 optimum: min words accessed (x1 + x2 + x3)."""
    case = nystrom_regime(n, r, P)
    if case == 1:
        return (n * n + n * r + r * r) / P
    if case == 2:
        return (n * n + n * r) / P + r
    if case == 3:
        return n * n / P + r + n * r / P
    return 2.0 * math.sqrt(n * r * (n + r) / P)


def nystrom_lower_bound(n: int, r: int, P: int) -> float:
    """Theorem 3: W_access - (n^2 + nr + r^2)/P, in words."""
    if not (r < n):
        raise ValueError(f"paper assumes r < n, got r={r}, n={n}")
    own = (n * n + n * r + r * r) / P
    return max(0.0, nystrom_access_lower_bound(n, r, P) - own)


# ---------------------------------------------------------------------------
# Numeric optimizers (executable re-proof of Lemmas 5 and 6)
# ---------------------------------------------------------------------------

def minimize_access_matmul(n1: int, n2: int, r: int, P: int,
                           iters: int = 200) -> float:
    """Numerically solve Lemma 5:

        min x1 + x2  s.t.  x1 x2 >= n1 n2 r / P,
                           x1 >= n1 n2 / P,  x2 >= n1 r / P.

    One-dimensional: on the optimum either the product constraint is tight
    or both box constraints bind, so sweep x1 over [lb1, hi] with
    x2 = max(lb2, K/x1) and take the min; golden-section refine.
    """
    K = n1 * n2 * r / P
    lb1 = n1 * n2 / P
    lb2 = n1 * r / P

    def obj(x1):
        x2 = max(lb2, K / x1)
        return x1 + x2

    hi = max(lb1, K / lb2) * 4.0 + 1.0
    lo = lb1
    # coarse log sweep then golden section
    best_x, best_v = lo, obj(lo)
    steps = 4096
    for i in range(steps + 1):
        x = lo * (hi / lo) ** (i / steps) if lo > 0 else lo + (hi - lo) * i / steps
        v = obj(x)
        if v < best_v:
            best_v, best_x = v, x
    gl, gr = max(lo, best_x / 1.1), min(hi, best_x * 1.1)
    phi = (math.sqrt(5) - 1) / 2
    a, b = gl, gr
    c, d = b - phi * (b - a), a + phi * (b - a)
    for _ in range(iters):
        if obj(c) < obj(d):
            b, d = d, c
            c = b - phi * (b - a)
        else:
            a, c = c, d
            d = a + phi * (b - a)
    return min(best_v, obj((a + b) / 2))


def minimize_access_nystrom(n: int, r: int, P: int,
                            grid: int = 256, refine: int = 60) -> float:
    """Numerically solve Lemma 6:

        min x1+x2+x3  s.t.  x1 x2 >= n^2 r/P,  x2 x3 >= n r^2/P,
                            x1 >= n^2/P, x2 >= nr/P, x3 >= r^2/P.

    For fixed x2, the optimum is x1 = max(n^2/P, n^2 r/(P x2)),
    x3 = max(r^2/P, n r^2 /(P x2)) — so sweep x2 (1-D) and refine.
    """
    K1 = n * n * r / P
    K2 = n * r * r / P
    lb1 = n * n / P
    lb2 = n * r / P
    lb3 = r * r / P

    def obj(x2):
        x1 = max(lb1, K1 / x2)
        x3 = max(lb3, K2 / x2)
        return x1 + x2 + x3

    lo = lb2
    hi = max(lb2 * 4, math.sqrt(K1) * 4, math.sqrt(K2) * 4, 4.0)
    best_x, best_v = lo, obj(lo)
    for i in range(grid * 16 + 1):
        x = lo * (hi / lo) ** (i / (grid * 16))
        v = obj(x)
        if v < best_v:
            best_v, best_x = v, x
    phi = (math.sqrt(5) - 1) / 2
    a, b = max(lo, best_x / 1.1), best_x * 1.1
    c, d = b - phi * (b - a), a + phi * (b - a)
    for _ in range(refine):
        if obj(c) < obj(d):
            b, d = d, c
            c = b - phi * (b - a)
        else:
            a, c = c, d
            d = a + phi * (b - a)
    return min(best_v, obj((a + b) / 2))


# ---------------------------------------------------------------------------
# Convenience report
# ---------------------------------------------------------------------------

@dataclass
class BoundReport:
    kind: str
    dims: tuple
    P: int
    regime: int
    words_lower_bound: float
    access_lower_bound: float
    gemm_words: float  # what a non-random GEMM would require

    @property
    def savings_vs_gemm(self) -> float:
        if self.words_lower_bound == 0:
            return float("inf") if self.gemm_words > 0 else 1.0
        return self.gemm_words / self.words_lower_bound


def report_matmul(n1: int, n2: int, r: int, P: int) -> BoundReport:
    return BoundReport(
        kind="sketch-matmul", dims=(n1, n2, r), P=P,
        regime=matmul_regime(n1, n2, r, P),
        words_lower_bound=matmul_lower_bound(n1, n2, r, P),
        access_lower_bound=matmul_access_lower_bound(n1, n2, r, P),
        gemm_words=gemm_lower_bound(n1, n2, r, P),
    )


def report_nystrom(n: int, r: int, P: int) -> BoundReport:
    return BoundReport(
        kind="nystrom", dims=(n, r), P=P,
        regime=nystrom_regime(n, r, P),
        words_lower_bound=nystrom_lower_bound(n, r, P),
        access_lower_bound=nystrom_access_lower_bound(n, r, P),
        gemm_words=(gemm_lower_bound(n, n, r, P)
                    + gemm_lower_bound(r, n, r, P)),
    )
