"""Cost model of Alg. 1, of Alg. 2 (the §5.2 Redistribute and the two-grid
variants), of one sharded row-slab stream update, of a sparse row slab's
payload and of the data-parallel gradient exchange (the parts of the
reference's ``plan/model.py`` that the port runs).

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

from repro_torch.core.grid import (alg1_bandwidth_words, alg1_latency_hops,
                                   alg2_bandwidth_words)
from repro_torch.kernels.sketch_matmul import (sketch_fwd_scratch_bytes,
                                               sketch_t_scratch_bytes)


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


def redistribute_words(n: int, r: int, p: Tuple[int, int, int],
                       q: Tuple[int, int, int]) -> float:
    """Per-processor words of the §5.2 Redistribute of B between the
    stage-1 and stage-2 grids as the reference prices it: zero when
    q == p, else the all-to-all bound n·r/P (the ``p != q`` term of
    ``alg2_bandwidth_words``).  Where p == q but the layouts P((p1, p2),
    p3) and P(q1, (q3, q2)) differ (e.g. (1, 2, 2)), B still moves; what
    moves is :func:`fused_redistribute_words`."""
    if tuple(p) == tuple(q):
        return 0.0
    P = p[0] * p[1] * p[2]
    return n * r / P


def fused_redistribute_words(n: int, r: int, p: Tuple[int, int, int],
                             q: Tuple[int, int, int]) -> float:
    """The most words any rank receives in the Redistribute of B from
    P((p1, p2), p3) to P(q1, (q3, q2)), both grids row-major over the
    same ranks: a rank keeps what its two blocks share and receives the
    rest, ``max over ranks of (q-block words) - (overlap words)``.  At
    most n·r/P; ``parallel.collectives.redistribute`` counts each rank's
    own term."""
    p1, p2, p3 = p
    q1, q2, q3 = q
    P = p1 * p2 * p3
    pr, pc = n / (p1 * p2), r / p3            # p-layout shard extents
    qr, qc = n / q1, r / (q2 * q3)            # q-layout shard extents
    worst = 0.0
    for d in range(P):
        rb, cb = divmod(d, p3)                # p-coords of rank d
        iq, rem = divmod(d, q2 * q3)          # q-coords of rank d
        jq, kq = divmod(rem, q3)
        col_blk = kq * q2 + jq                # cols sharded (q3, q2)-major
        ov_r = max(0.0, min(rb * pr + pr, iq * qr + qr)
                   - max(rb * pr, iq * qr))
        ov_c = max(0.0, min(cb * pc + pc, col_blk * qc + qc)
                   - max(cb * pc, col_blk * qc))
        worst = max(worst, qr * qc - ov_r * ov_c)
    return worst


def alg2_cost(n: int, r: int, p: Tuple[int, int, int],
              q: Tuple[int, int, int]) -> Cost:
    """Alg. 2 on grids (p, q): words is ``alg2_bandwidth_words`` exactly
    and messages the reference's count.

    Device-memory words price the port's local bodies: stage 1 as
    :func:`alg1_cost` (``sketch_fwd``), stage 2's ``sketch_t`` reading the
    gathered (n/q1, r/q3) block of B, drawing its (n/q1 x r/q2) Omega
    block into a scratch (``sketch_t_scratch_bytes``) that it writes and
    reads once, and writing the (r/q2, r/q3) partial of C (the
    reference's fused Pallas bodies keep Omega out of HBM; these do
    not)."""
    p1, p2, p3 = p
    q1, q2, q3 = q
    P = p1 * p2 * p3
    scratch = sketch_t_scratch_bytes(r // q2, n // q1) / 4
    hbm = (alg1_cost(n, n, r, p).hbm_words + n * r / (q1 * q3)
           + 2.0 * scratch + r * r / (q2 * q3))
    msgs = alg1_latency_hops(p2, p3) + math.log2(max(p1, 1))
    if tuple(p) != tuple(q):
        msgs += math.log2(max(P, 1))  # the all-to-all redistribution
    return Cost(words=alg2_bandwidth_words(n, r, p, q), messages=msgs,
                flops=(2.0 * n * n * r + 2.0 * n * r * r) / P,
                hbm_words=hbm)


def alg2_fused_cost(n: int, r: int, p: Tuple[int, int, int],
                    q: Tuple[int, int, int]) -> Cost:
    """Alg. 2 with the Redistribute priced at what moves: the words of
    :func:`alg2_cost` with its n·r/P term replaced by
    :func:`fused_redistribute_words`, and its log2(P) hops by one
    collective (the reference's ``alg2_fused_cost``; the port runs every
    pair this way)."""
    _, p2, p3 = p
    base = alg2_cost(n, r, p, q)
    cross = redistribute_words(n, r, p, q)
    fused = fused_redistribute_words(n, r, p, q)
    msgs = alg1_latency_hops(p2, p3) + math.log2(max(p[0], 1))
    if fused > 0.0:
        msgs += 1.0                   # one resharding collective
    return dataclasses.replace(base, words=base.words - cross + fused,
                               messages=msgs)


def stream_update_cost(k: int, n2: int, r: int, l: int,
                       grid: Tuple[int, int, int] = (1, 1, 1),
                       corange: bool = True) -> Cost:
    """One ``ShardedStreamingSketch.update_rows`` of a (k, n2) slab on
    (p1, p2, p3): ``words`` and ``messages`` are the reference's exactly.

    The slab is replicated over p1 and column-split over (p2, p3): one
    all-gather of it over p3 ((1 - 1/p3)·k·n2/p2 words), one all-reduce
    of the (k, r/p3) dY partial over p2 (2·(1 - 1/p2)·k·r/p3), and W's
    update is local (W is replicated over p1).  Zero words on (1, 1, 1)
    and on every regime-1 grid (P, 1, 1).

    Device-memory words price the port's bodies as :func:`alg1_cost`
    does: ``sketch_fwd`` reads the gathered (k, n2/p2) panel, writes and
    reads its (n2/p2 x r/p3) Omega scratch (``sketch_fwd_scratch_bytes``)
    and writes dY; the fold reads dY and the Y rows it meets (at most k)
    and writes those rows; with the co-range, ``sketch_t`` reads the
    local (k, n2/(p2·p3)) block, writes and reads its (k x l) Psi scratch
    (``sketch_t_scratch_bytes``) and reads and writes W's block."""
    p1, p2, p3 = grid
    words = 0.0
    msgs = 0.0
    if p3 > 1:
        words += (1.0 - 1.0 / p3) * k * n2 / p2
        msgs += math.log2(p3)
    if p2 > 1:
        words += 2.0 * (1.0 - 1.0 / p2) * k * r / p3   # all-reduce of dY
        msgs += 2.0 * math.log2(p2)
    cols = n2 / (p2 * p3)
    flops = 2.0 * k * n2 * r / (p2 * p3)
    scratch = sketch_fwd_scratch_bytes(r // p3, n2 // p2) / 4
    hbm = k * n2 / p2 + 2.0 * scratch + 4.0 * k * r / p3
    if corange:
        flops += 2.0 * k * n2 * l / (p2 * p3)
        hbm += (k * cols + 2.0 * sketch_t_scratch_bytes(l, k) / 4
                + 2.0 * l * cols)
    return Cost(words=words, messages=msgs, flops=flops, hbm_words=hbm)


def sparse_payload_words(nnz: int) -> float:
    """Wire/storage words of a COO payload: one index and one value a
    stored entry, ``2·nnz`` — what a sparse row slab
    (``stream.SparseRows``) costs to ship instead of its dense (k, n2)
    frame.  (The reference's ``sparse_sketch_cost`` and its scatter
    penalty belong to the planner, ROADMAP Queue 1 item 7.)"""
    return 2.0 * float(nnz)


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
