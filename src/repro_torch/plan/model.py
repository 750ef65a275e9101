"""Cost model of Alg. 1 and of the data-parallel gradient exchange (the
parts of the reference's ``plan/model.py`` that the port runs).

Counts only: words moved over the interconnect, latency hops, local FLOPs
and device-memory words.  The reference also prices seconds on TPU
machine presets; the port has no measured H100 machine model yet
(ROADMAP.md Queue 1, item 7), so it prices none and inherits none of the
TPU presets.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from repro_torch.core.grid import alg1_bandwidth_words, alg1_latency_hops
from repro_torch.kernels.sketch_matmul import sketch_fwd_scratch_bytes


@dataclasses.dataclass(frozen=True)
class Cost:
    """Per-processor resource counts for one variant (paper units)."""
    words: float            # interconnect words moved (the paper's W)
    flops: float            # local FLOPs
    messages: float = 0.0   # latency hops on the critical path
    hbm_words: float = 0.0  # device-memory words touched (reads + writes)


def alg1_cost(n1: int, n2: int, r: int,
              grid: Tuple[int, int, int]) -> Cost:
    """Alg. 1 on (p1, p2, p3): words is the paper's closed form exactly.

    The local body is ``sketch_block``, which on the card is ``sketch_fwd``:
    it draws its Omega block (n2/p2 rows, r/p3 columns) once a call into
    a device-memory scratch (``sketch_fwd_scratch_bytes``) and reads it
    back, so the block is priced written once and read once (the
    reference's fused Pallas body keeps it out of HBM; this one does not).
    Per rank: the gathered A panel read, the Omega scratch written and
    read, the B partial written."""
    p1, p2, p3 = grid
    P = p1 * p2 * p3
    scratch = sketch_fwd_scratch_bytes(r // p3, n2 // p2) / 4
    hbm = n1 * n2 / (p1 * p2) + 2.0 * scratch + n1 * r / (p1 * p3)
    return Cost(words=alg1_bandwidth_words(n1, n2, r, p1, p2, p3),
                flops=2.0 * n1 * n2 * r / P,
                messages=alg1_latency_hops(p2, p3), hbm_words=hbm)


def alg1_communicating_cost(n1: int, n2: int, r: int,
                            grid: Tuple[int, int, int]) -> Cost:
    """The Fig.-3 baseline: Omega all-gathered over the whole grid instead
    of regenerated; each rank receives the (1 - 1/P)·n2·r words it does
    not draw itself."""
    base = alg1_cost(n1, n2, r, grid)
    P = grid[0] * grid[1] * grid[2]
    return dataclasses.replace(
        base, words=base.words + (1.0 - 1.0 / P) * n2 * r,
        messages=base.messages + math.log2(max(P, 1)))


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
