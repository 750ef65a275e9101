"""Cost model of the data-parallel gradient exchange (the part of the
reference's ``plan/model.py`` that training needs).

Counts only: words moved over the interconnect and local FLOPs.  The
reference also prices seconds on TPU machine presets; the port has no
measured H100 machine model yet (ROADMAP.md Queue 1, item 7), so it prices
none and inherits none of the TPU presets.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Cost:
    """Per-processor resource counts for one variant (paper units)."""
    words: float          # interconnect words moved (the paper's W)
    flops: float          # local FLOPs


def grad_allreduce_cost(m: int, n: int, world: int) -> Cost:
    """Raw exchange of one (m, n) gradient leaf: one all-reduce of the
    whole operand, ``m·n`` words per processor (the reference's unit: a
    collective counted at its per-device operand size).  ``world <= 1`` is
    free: a mean over one worker moves nothing."""
    if world <= 1:
        return Cost(words=0.0, flops=0.0)
    return Cost(words=float(m * n), flops=float(m * n))


def grad_compress_cost(m: int, n: int, r: int, world: int) -> Cost:
    """Sketched exchange of one (m, n) leaf at rank r: Omega is regenerated
    on every worker (zero words), so only the factors move,

        P  = mean((G+E)·Omega)      m·r words
        Qᵀ = mean(P̂ᵀ·(G+E))         r·n words

    ``r·(m+n)`` words against the raw ``m·n``.  Local work: four rank-r
    GEMMs, the thin QR (``2·m·r²``) and the ``M = G+E`` add."""
    r = min(r, m, n)
    words = float(r * (m + n)) if world > 1 else 0.0
    flops = 8.0 * m * n * r + 2.0 * m * r * r + float(m * n)
    return Cost(words=words, flops=flops)
