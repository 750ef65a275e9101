"""Machine model and analytic costs of the port's executable variants (the
reference's ``plan/model.py``, priced for the port's kernels).

The paper's cost model (§3) counts words moved per processor in the
alpha-beta model; the entry points add local FLOPs and device-memory
words.  :meth:`Cost.seconds` turns the four counts into predicted seconds
on a :class:`MachineModel`, and the raw counts stay visible so tests can
hold the paper's closed forms exactly.  Words, messages and FLOPs of every
function are the reference's; ``hbm_words`` prices the port's bodies:

  * ``alg1_cost``, ``alg1_communicating_cost`` — Alg. 1 on (p1, p2, p3);
  * ``alg2_cost``, ``alg2_fused_cost`` — Alg. 2 on (p, q), the
    Redistribute priced as the reference prices it, or at what moves;
  * ``local_cost``, ``hbm_roofline_words`` — one ``sketch_fwd`` call;
  * ``nystrom_local_cost`` — ``ops.nystrom_fused`` (``sketch_fwd`` then
    ``sketch_t``);
  * ``local_torch_cost``, ``nystrom_local_torch_cost`` — the same with
    Omega materialized by ``gen_omega`` and multiplied by ``torch.matmul``
    (``sketch_reference``, ``nystrom_reference``);
  * ``stream_update_cost`` — one row-slab stream update (local or sharded);
  * ``stream_reshard_words``, ``stream_reshard_traffic_words`` — the live
    reshard of a sharded stream (the min-cut the port moves; the
    reference's compiled relayout);
  * ``sparse_sketch_cost``, ``sparse_stream_update_cost`` — the sparse
    Omega families and COO slabs, all four counts the reference's;
  * ``grad_allreduce_cost``, ``grad_compress_cost`` — one leaf of the
    data-parallel gradient exchange;
  * ``ragged_bucket_cost``, ``choose_bucket_edges`` — the ragged ingest's
    shape buckets.

The port's ``sketch_fwd`` and ``sketch_t`` draw their Omega slab once a
call into a device-memory scratch, and a call split over K adds an f32
work buffer of its partial sums (``sketch_fwd_plan``, ``sketch_t_plan``):
both are priced written once and read once.  There is no ``backend``
argument: the port has one body a device, and no fused body that keeps
Omega out of device memory.

The machine entries hold no TPU number.  The H100 entry's compute and
memory rates are datasheet peaks; its network terms are a least-squares
fit of this repo's own card records (``plan.autotune``), and describe
four gloo ranks that share one card and stage through host memory, not
NVLink or NCCL.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.core.grid import (alg1_bandwidth_words, alg1_latency_hops,
                                   alg2_bandwidth_words)
from repro_torch.kernels.sketch_matmul import (gemm_plan, sketch_fwd_plan,
                                               sketch_t_plan)


# ---------------------------------------------------------------------------
# Machine model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Alpha-beta-gamma machine: network latency and bandwidth, compute and
    memory.

    alpha      : per-message latency (seconds)
    byte_bw    : interconnect bandwidth per device (bytes/s), 1/beta
    flop_rate  : peak FLOP/s per device
    hbm_bw     : device-memory bandwidth (bytes/s)
    smem_bytes : shared memory of one streaming multiprocessor (the
                 reference's ``vmem_bytes``, the fast scratch a kernel's
                 tiles must fit)
    hbm_bytes  : device memory capacity
    dispatch_overhead : host cost of one bucket of the ragged ingest
                 (seconds), the term that bucketing amortizes
                 (:func:`choose_bucket_edges`)
    """
    name: str
    alpha: float
    byte_bw: float
    flop_rate: float
    hbm_bw: float
    smem_bytes: int
    hbm_bytes: int
    dispatch_overhead: float = 5e-5


H100_GLOO = "h100_gloo_1card"

PRESETS = {
    # The reference's host entry, number for number, so that seconds on
    # the CPU compare exactly with the reference's.
    "cpu": MachineModel(
        name="cpu", alpha=5e-6, byte_bw=10e9, flop_rate=5e10,
        hbm_bw=20e9, smem_bytes=32 * 2 ** 20, hbm_bytes=8 * 2 ** 30,
        dispatch_overhead=3e-4),
    # NVIDIA H100 80GB HBM3 at a 700.00 W power limit (nvidia-smi
    # --query-gpu=name,power.limit).  Datasheet peaks: flop_rate (f32
    # outside the tensor cores, the rate of the port's IEEE-f32 SIMT
    # kernels) and hbm_bw.  Measured on that card by chip_smoke.py:
    # smem_bytes (shared_memory_per_multiprocessor), hbm_bytes
    # (total_memory), dispatch_overhead (phase 8: staging a one-lane
    # bucket and one fold_rows_block call, host clock, median of 200),
    # and alpha and byte_bw, the calibrate_machine_model fit of the
    # records in h100_sweep.json beside this module (phases 3-4 and
    # 12-16; the network terms come from phases 12-15's four gloo ranks
    # sharing the one card).
    H100_GLOO: MachineModel(
        name=H100_GLOO, alpha=0.010839607135641591,
        byte_bw=401110843.0092646, flop_rate=67e12, hbm_bw=3.35e12,
        smem_bytes=233472, hbm_bytes=85017493504,
        dispatch_overhead=76.1e-6),
}


def _device(device) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def probe_machine(device=None) -> MachineModel:
    """The entry of ``device`` (default: the CUDA card when there is one,
    else the CPU): the ``cpu`` entry for the CPU, the H100 entry for a
    card whose name holds "H100".  Any other card raises: pass an
    explicit ``machine=`` instead."""
    device = _device(device)
    if device.type == "cpu":
        return PRESETS["cpu"]
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        if "H100" in name:
            return PRESETS[H100_GLOO]
        raise ValueError(f"no machine model for the card {name!r}: pass "
                         f"machine= (a MachineModel) explicitly")
    raise ValueError(f"no machine model for device {device}: pass machine=")


def device_kind_tag(device=None) -> str:
    """The device's kind, spaces replaced by ``_`` (``NVIDIA_H100_80GB_
    HBM3``; ``cpu`` for the CPU): the key of a card's records."""
    device = _device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device).replace(" ", "_")
    return device.type


# ---------------------------------------------------------------------------
# Cost breakdown
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Cost:
    """Per-processor resource counts for one variant (paper units)."""
    words: float            # interconnect words moved (the paper's W)
    flops: float            # local FLOPs
    messages: float = 0.0   # latency hops on the critical path
    hbm_words: float = 0.0  # device-memory words touched (reads + writes)

    def seconds(self, machine: MachineModel, itemsize: int = 4) -> float:
        """Predicted seconds: local work overlaps compute with memory (the
        larger term), and the collectives run serialized with it, so
        network time and latency are added."""
        t_net = self.words * itemsize / machine.byte_bw
        t_flop = self.flops / machine.flop_rate
        t_mem = self.hbm_words * itemsize / machine.hbm_bw
        return max(t_flop, t_mem) + t_net + self.messages * machine.alpha

    def bottleneck(self, machine: MachineModel, itemsize: int = 4) -> str:
        terms = {
            "network": self.words * itemsize / machine.byte_bw,
            "compute": self.flops / machine.flop_rate,
            "memory": self.hbm_words * itemsize / machine.hbm_bw,
        }
        return max(terms, key=terms.get)


def _fwd_words(m: int, n: int, K: int) -> float:
    """Device-memory words of one ``sketch_fwd`` call's own buffers: its
    Omega scratch and, when split, its work buffer, each written and read
    once.  An empty output (a grid that does not divide the shape) draws
    nothing."""
    if m <= 0 or n <= 0:
        return 0.0
    plan = sketch_fwd_plan(m, n, K)
    return 2.0 * (plan["scratch_bytes"] + plan["work_bytes"]) / 4


def _t_words(m: int, n: int, K: int) -> float:
    """The same for one ``sketch_t`` call of (K, n) -> (m, n)."""
    if m <= 0 or n <= 0:
        return 0.0
    plan = sketch_t_plan(m, n, K)
    return 2.0 * (plan["scratch_bytes"] + plan["work_bytes"]) / 4


# ---------------------------------------------------------------------------
# Variant costs — sketch  B = A·Omega  (n1 x n2  @  n2 x r)
# ---------------------------------------------------------------------------

def alg1_cost(n1: int, n2: int, r: int,
              grid: Tuple[int, int, int]) -> Cost:
    """Alg. 1 on (p1, p2, p3): words is the paper's closed form exactly.

    The local body is ``sketch_fwd`` of the gathered (n1/p1, n2/p2) A
    panel into the (n1/p1, r/p3) B partial.  Per rank: the panel read,
    the call's Omega scratch and work buffer (``sketch_fwd_plan``) written
    and read, the partial written."""
    p1, p2, p3 = grid
    P = p1 * p2 * p3
    hbm = (n1 * n2 / (p1 * p2) + _fwd_words(n1 // p1, r // p3, n2 // p2)
           + n1 * r / (p1 * p3))
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


def hbm_roofline_words(m: int, k: int, n: int,
                       accumulate: bool = False) -> float:
    """Device-memory words of one ``sketch_fwd`` call of (m x k)·(k x n):
    A read once, the Omega scratch and (when split) the work buffer
    written and read (``sketch_fwd_plan``), out written, or read and
    written in place with ``accumulate=True``."""
    out = (2.0 if accumulate else 1.0) * m * n
    return m * k + _fwd_words(m, n, k) + out


def local_cost(n1: int, n2: int, r: int) -> Cost:
    """One-card sketch: one ``sketch_fwd`` call of A (n1, n2) -> (n1, r)."""
    return Cost(words=0.0, messages=0.0, flops=2.0 * n1 * n2 * r,
                hbm_words=hbm_roofline_words(n1, n2, r))


def local_torch_cost(n1: int, n2: int, r: int) -> Cost:
    """One-card sketch with Omega materialized (``sketch_reference``):
    A read, Omega written by ``gen_omega`` and read by ``torch.matmul``,
    B written.  Words, messages and FLOPs are the reference's
    ``local_cost``."""
    return Cost(words=0.0, messages=0.0, flops=2.0 * n1 * n2 * r,
                hbm_words=float(n1 * n2 + 2 * n2 * r + n1 * r))


# ---------------------------------------------------------------------------
# Variant costs — Nyström  (B = A·Omega ; C = Omega^T·B)
# ---------------------------------------------------------------------------

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
    gathered (n/q1, r/q3) block of B, writing and reading its Omega
    scratch and, when split, its work buffer (``sketch_t_plan`` of the
    (r/q2, r/q3) output over K = n/q1), and writing the C partial."""
    p1, p2, p3 = p
    q1, q2, q3 = q
    P = p1 * p2 * p3
    hbm = (alg1_cost(n, n, r, p).hbm_words + n * r / (q1 * q3)
           + _t_words(r // q2, r // q3, n // q1) + r * r / (q2 * q3))
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


def nystrom_local_cost(n: int, r: int) -> Cost:
    """One-card Nyström pair, ``ops.nystrom_fused``: ``sketch_fwd`` of A
    (n, n) -> B (n, r), then ``sketch_t`` of B -> C (r, r), each with its
    Omega scratch (and work buffer when split) written and read.  The
    reference's ``fused=True`` discount has no counterpart: both bodies
    write their scratch."""
    return Cost(words=0.0, messages=0.0,
                flops=2.0 * n * n * r + 2.0 * n * r * r,
                hbm_words=(hbm_roofline_words(n, n, r) + n * r
                           + _t_words(r, r, n) + r * r))


def nystrom_local_torch_cost(n: int, r: int) -> Cost:
    """One-card Nyström pair with Omega materialized
    (``nystrom_reference``): A read, Omega written by ``gen_omega`` and
    read, B written; then Omega and B read again by ``Omega^T·B`` and C
    written.  Words, messages and FLOPs are the reference's
    ``nystrom_local_cost``."""
    return Cost(words=0.0, messages=0.0,
                flops=2.0 * n * n * r + 2.0 * n * r * r,
                hbm_words=float(n * n + 5 * n * r + r * r))


# ---------------------------------------------------------------------------
# Variant costs — streaming ingest (one row-slab update of k rows)
# ---------------------------------------------------------------------------

def stream_update_cost(k: int, n2: int, r: int, l: int,
                       grid: Tuple[int, int, int] = (1, 1, 1),
                       corange: bool = True) -> Cost:
    """One ``update_rows`` of a (k, n2) slab on (p1, p2, p3): ``words``,
    ``messages`` and ``flops`` are the reference's exactly.

    The slab is replicated over p1 and column-split over (p2, p3): one
    all-gather of it over p3 ((1 - 1/p3)·k·n2/p2 words), one all-reduce
    of the (k, r/p3) dY partial over p2 (2·(1 - 1/p2)·k·r/p3), and W's
    update is local (W is replicated over p1).  Zero words on (1, 1, 1)
    and on every regime-1 grid (P, 1, 1).

    Device-memory words price the port's bodies: ``sketch_fwd`` reads the
    gathered (k, n2/p2) panel, writes and reads its Omega scratch and,
    when split, its work buffer (``sketch_fwd_plan``), and writes dY; the
    fold reads dY and the Y rows it meets (at most k) and writes those
    rows; with the co-range, ``sketch_t`` reads the local (k, n2/(p2·p3))
    block, writes and reads its Psi scratch and work buffer
    (``sketch_t_plan``) and reads and writes W's block."""
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
    hbm = k * n2 / p2 + _fwd_words(k, r // p3, n2 // p2) + 4.0 * k * r / p3
    if corange:
        flops += 2.0 * k * n2 * l / (p2 * p3)
        hbm += (k * cols + _t_words(l, n2 // (p2 * p3), k)
                + 2.0 * l * cols)
    return Cost(words=words, messages=msgs, flops=flops, hbm_words=hbm)


#: Flop-rate penalty of scalar scatter-adds against the dense GEMM's
#: vectorized FMAs (the reference's knob, kept as it is).
SPARSE_SCATTER_PENALTY = 8.0


def sparse_payload_words(nnz: int) -> float:
    """Wire/storage words of a COO payload: one index and one value a
    stored entry, ``2·nnz`` — what a sparse row slab
    (``stream.SparseRows``) costs to ship instead of its dense (k, n2)
    frame."""
    return 2.0 * float(nnz)


def _sparse_participation(n2: int, r: int, kind: str) -> float:
    """Fraction of input columns a sparse Omega touches: CountSketch hits
    every row of Omega; coordinated row sampling keeps a row with
    probability r/n2."""
    return min(1.0, r / max(n2, 1)) if kind == "rowsample" else 1.0


def sparse_sketch_cost(n1: int, n2: int, r: int, nnz: float,
                       grid: Tuple[int, int, int] = (1, 1, 1),
                       kind: str = "countsketch") -> Cost:
    """B = A·Omega with a sparse Omega family (CountSketch, coordinated
    row sampling) on a stored-sparse A of ``nnz`` nonzeros, all four
    counts the reference's: one scatter-add an entry at
    ``SPARSE_SCATTER_PENALTY`` times the dense flop rate; a COO panel of
    ``2·nnz_eff/(p1·p2)`` words all-gathered over p3 (``nnz_eff`` =
    ``nnz·r/n2`` for rowsample, whose senders filter by the
    seed-coordinated membership); the dense B partial reduce-scattered
    over p2."""
    p1, p2, p3 = grid
    P = p1 * p2 * p3
    nnz_eff = float(nnz) * _sparse_participation(n2, r, kind)
    words = 0.0
    msgs = 0.0
    if p3 > 1:
        words += (1.0 - 1.0 / p3) * sparse_payload_words(nnz_eff) / (p1 * p2)
        msgs += math.log2(p3)
    if p2 > 1:
        words += (1.0 - 1.0 / p2) * n1 * r / (p1 * p3)
        msgs += math.log2(p2)
    flops = 2.0 * nnz_eff * SPARSE_SCATTER_PENALTY / P
    hbm = (sparse_payload_words(nnz_eff) + 2.0 * nnz_eff + n1 * r) / P
    return Cost(words=words, messages=msgs, flops=flops, hbm_words=hbm)


def sparse_stream_update_cost(k: int, n2: int, r: int, l: int, nnz: float,
                              grid: Tuple[int, int, int] = (1, 1, 1),
                              corange: bool = True,
                              kind: str = "countsketch") -> Cost:
    """One ``update_rows_sparse`` of a (k, n2) COO slab of ``nnz`` stored
    entries, all four counts the reference's.  The port's S1 gathers
    Omega's and Psi's rows through the L2 (its time follows those bytes,
    ``PERF.md`` §6, S1), which this device-memory count leaves out, as
    the reference's does.

    Zero words on one card; sharded grids would ship the COO panel over
    p3 and all-reduce the dense dY over p2.  A sparse kind folds one
    scatter-add an entry into Y (and one into W with the co-range); a
    dense kind gathers an r-row of Omega an entry (nnz·r flops) and an
    l-row of Psi likewise."""
    p1, p2, p3 = grid
    nnz_eff = float(nnz) * _sparse_participation(n2, r, kind)
    sparse_om = kind in ("countsketch", "rowsample")
    words = 0.0
    msgs = 0.0
    if p3 > 1:
        words += (1.0 - 1.0 / p3) * sparse_payload_words(nnz_eff) / p2
        msgs += math.log2(p3)
    if p2 > 1:
        words += 2.0 * (1.0 - 1.0 / p2) * k * r / p3   # all-reduce of dY
        msgs += 2.0 * math.log2(p2)
    per_entry = 1.0 if sparse_om else float(r)
    flops = 2.0 * nnz_eff * per_entry * SPARSE_SCATTER_PENALTY / (p2 * p3)
    hbm = ((sparse_payload_words(nnz_eff) + 2.0 * nnz_eff) / (p2 * p3)
           + 4.0 * k * r / p3)
    if corange:
        flops += (2.0 * nnz_eff * (1.0 if sparse_om else float(l))
                  * SPARSE_SCATTER_PENALTY / (p2 * p3))
        hbm += (2.0 * nnz_eff + 2.0 * l * n2) / (p2 * p3)
    return Cost(words=words, messages=msgs, flops=flops, hbm_words=hbm)


def stream_reshard_words(n1: int, r: int, p: Tuple[int, int, int],
                         q: Tuple[int, int, int], *, l: int = 0,
                         n2: int = 0, corange: bool = False) -> float:
    """Per-processor words of the one-hop reshard of a live stream's
    (Y, W) from grid ``p`` onto grid ``q`` (``stream/elastic.py``): the
    reference's formula, unchanged.

    The exact per-device min-cut over the shared rank order: each rank
    keeps the overlap of its old and new blocks and receives the rest, so
    the cost is the maximum over receiving ranks of (new block words) -
    (overlap words).  Y (n1 x r) is P((p1, p2), p3): rank d holds row
    block d // p3 of p1·p2 and column block d % p3; W (l x n2), with
    ``corange``, is P(None, (p2, p3)): replicated over p1, column block
    d % (p2·p3).  Grids are the first P ranks, so the first min(P, Q)
    ranks keep their overlap, ranks past ``p`` receive whole blocks and
    ranks past ``q`` only send.  Coinciding layouts cost 0.

    The port's hop moves exactly this: ``stream.elastic.rank_words`` gives
    each rank's words, and their maximum is this function."""
    p1, p2, p3 = p
    q1, q2, q3 = q
    P, Q = p1 * p2 * p3, q1 * q2 * q3
    pr, pc = n1 / (p1 * p2), r / p3          # old Y shard extents
    qr, qc = n1 / (q1 * q2), r / q3          # new Y shard extents
    worst = 0.0
    for d in range(Q):
        nrb, ncb = divmod(d, q3)
        need = qr * qc
        if d < P:
            rb, cb = divmod(d, p3)
            ov_r = max(0.0, min(rb * pr + pr, nrb * qr + qr)
                       - max(rb * pr, nrb * qr))
            ov_c = max(0.0, min(cb * pc + pc, ncb * qc + qc)
                       - max(cb * pc, ncb * qc))
            need -= ov_r * ov_c
        if corange:
            wp, wq = n2 / (p2 * p3), n2 / (q2 * q3)   # W col extents
            nwb = d % (q2 * q3)
            w_need = l * wq
            if d < P:
                wb = d % (p2 * p3)
                ov_w = max(0.0, min(wb * wp + wp, nwb * wq + wq)
                           - max(wb * wp, nwb * wq))
                w_need -= l * ov_w
            need += w_need
        worst = max(worst, need)
    return worst


def stream_reshard_traffic_words(n1: int, r: int, p: Tuple[int, int, int],
                                 q: Tuple[int, int, int], *, l: int = 0,
                                 n2: int = 0,
                                 corange: bool = False) -> float:
    """Per-processor words the reference's COMPILED one-hop relayout
    moves (XLA's full-shard relayout), the reference's formula unchanged.

    The port's hop does not move this: it moves the min-cut
    :func:`stream_reshard_words` by one uneven all-to-all, and its ledger
    predicts that.  This function is kept for parity with the planner.

    * **Y** (P((p1,p2), p3)).  Coinciding maps (equal block counts and
      device count): 0 words.  Re-splitting an already split column axis
      (p3 > 1, q3 > 1, p3 != q3) costs two full new shards; every other
      change one.
    * **W** (P(None, (p2,p3))).  Same block count on the same devices: 0.
      Out of a replicated layout onto the same or fewer devices: 0.  A
      coarser split: the old shard (twice when the target is still
      split).  A finer split: one new shard.
    """
    p1, p2, p3 = p
    q1, q2, q3 = q
    P, Q = p1 * p2 * p3, q1 * q2 * q3
    words = 0.0
    same_y = (p1 * p2 == q1 * q2 and p3 == q3 and P == Q)
    if not same_y:
        hops = 2.0 if (p3 > 1 and q3 > 1 and p3 != q3) else 1.0
        words += hops * n1 / (q1 * q2) * (r / q3)
    if corange:
        bp, bq = p2 * p3, q2 * q3
        if bp == bq and P == Q:
            pass
        elif bp == 1 and Q <= P:
            pass
        elif bq < bp:
            words += (2.0 if bq > 1 else 1.0) * l * n2 / bp
        else:
            words += l * n2 / bq
    return words


# ---------------------------------------------------------------------------
# Variant costs — data-parallel gradient exchange (parallel/grad_compress.py)
# ---------------------------------------------------------------------------

def grad_allreduce_cost(m: int, n: int, world: int) -> Cost:
    """Raw exchange of one (m, n) gradient leaf: one all-reduce of the
    whole operand, ``m·n`` words per processor (the reference's unit: a
    collective counted at its per-device operand size) and log2(P) hops.
    Device memory: the all-reduce reads and writes the bf16 leaf, its
    division by the world size again, 2·m·n words.  ``world <= 1`` is
    free: ``allreduce_mean`` is the identity there."""
    if world <= 1:
        return Cost(words=0.0, flops=0.0)
    return Cost(words=float(m * n), flops=float(m * n),
                messages=math.log2(world), hbm_words=2.0 * m * n)


def grad_compress_cost(m: int, n: int, r: int, world: int) -> Cost:
    """Sketched exchange of one (m, n) leaf at rank r: Omega is regenerated
    on every worker (zero words), so only the factors move,

        P  = mean((G+E)·Omega)      m·r words
        Qᵀ = mean(P̂ᵀ·(G+E))         r·n words

    ``r·(m+n)`` words against the raw ``m·n``, in 2·log2(P) hops.  Local
    work: four rank-r GEMMs, the thin QR (``2·m·r²``) and the ``M = G+E``
    add.  Device memory, for the port's exchange of a bf16 gradient (half
    a word an element) with an f32 error buffer: the add reads E and G
    and writes M into E; ``sketch_fwd`` of M (:func:`hbm_roofline_words`,
    its narrow path at r <= 16); the QR reads P and writes P̂; then the
    three ``gemm`` calls with the paths and work buffers ``gemm_plan``
    names: (a) ``P̂ᵀ·M`` reads both and writes Qᵀ, (b) ``P̂·Qᵀ`` writes the
    bf16 Ĝ into G, (c) ``M - P̂·Qᵀ`` reads and writes M in place."""
    r = min(r, m, n)
    words = float(r * (m + n)) if world > 1 else 0.0
    msgs = 2.0 * math.log2(world) if world > 1 else 0.0
    flops = 8.0 * m * n * r + 2.0 * m * r * r + float(m * n)
    factors = m * r + r * n                    # P̂ and Qᵀ read by a gemm

    def work(M_, N_, K_):
        return 2.0 * gemm_plan(M_, N_, K_)["work_bytes"] / 4

    hbm = 2.5 * m * n                                    # M = G + E
    hbm += hbm_roofline_words(m, n, r) + 2.0 * m * r     # sketch, QR
    hbm += m * r + m * n + r * n + work(r, n, m)         # (a) Qᵀ = P̂ᵀ·M
    hbm += factors + 0.5 * m * n + work(m, n, r)         # (b) Ĝ, bf16
    hbm += factors + 2.0 * m * n + work(m, n, r)         # (c) E' in place
    return Cost(words=words, flops=flops, messages=msgs, hbm_words=hbm)


# ---------------------------------------------------------------------------
# Ragged-ingest bucket planning (padded lanes against dispatch amortization)
# ---------------------------------------------------------------------------

def ragged_bucket_cost(ks, kb: int, n2: int, r: int, l: int,
                       corange: bool = True, machine: MachineModel = None,
                       itemsize: int = 4) -> float:
    """Predicted seconds of one bucket of ``len(ks)`` ragged lanes padded
    to height ``kb`` (each ``k in ks`` at most kb): the machine's
    ``dispatch_overhead`` once, then every lane at the price of a full
    kb-row :func:`stream_update_cost`, as the reference prices a padded
    lane.

    On the card a bucket is one staging of its (lanes, kb, n2) frame and
    one fold launch (``stream/state.py`` ``local_rowblock_ragged``); each
    lane also takes one ``sketch_fwd`` and one ``sketch_t`` wrapper call.
    Those per-lane host calls are the same for every bucketing, so they
    move no edge and are left out of the price."""
    machine = machine or probe_machine()
    lane = stream_update_cost(kb, n2, r, l, corange=corange)
    return (machine.dispatch_overhead
            + len(list(ks)) * lane.seconds(machine, itemsize))


def choose_bucket_edges(ks, n2: int, r: int, l: int = None,
                        corange: bool = True, machine: MachineModel = None,
                        itemsize: int = 4) -> list:
    """Bucket tops for a ragged ingest workload, priced by
    :func:`ragged_bucket_cost`.

    ``ks`` is the observed distribution of lane heights (one entry an
    update).  Returns ascending bucket tops (for
    ``SketchService.update_ragged(bucket_edges=...)`` /
    ``IngestQueue(bucket_edges=...)``); a lane is padded up to the
    smallest edge at least its height.

    Exact DP over the sorted distinct heights (buckets are contiguous
    height ranges in an optimal solution), minimizing

        sum over buckets [ dispatch_overhead
                           + count(bucket) · lane_seconds(bucket top) ].

    Zero dispatch cost gives one bucket per distinct height; a dispatch
    cost that dominates the lanes' work gives one bucket at max(ks).
    Height 1, when present, is always its own bucket (``snap_bucket``
    never pads a one-row slab), so the DP plans the other heights around
    a mandatory [1] edge."""
    machine = machine or probe_machine()
    if l is None:
        l = 2 * r + 1
    ks = sorted(int(k) for k in ks)
    if not ks:
        return []
    if ks[0] <= 1:
        rest = [k for k in ks if k > 1]
        return [1] + choose_bucket_edges(rest, n2, r, l, corange=corange,
                                         machine=machine, itemsize=itemsize)
    uniq = sorted(set(ks))
    counts = [ks.count(u) for u in uniq]
    lane_s = [stream_update_cost(u, n2, r, l, corange=corange)
              .seconds(machine, itemsize) for u in uniq]
    m = len(uniq)
    best = [0.0] * (m + 1)          # best[j]: heights uniq[:j] bucketed
    cut = [0] * (m + 1)
    for j in range(1, m + 1):
        best[j] = math.inf
        tail = 0
        for i in range(j, 0, -1):   # bucket = uniq[i-1 .. j-1], top uniq[j-1]
            tail += counts[i - 1]
            c = best[i - 1] + machine.dispatch_overhead + tail * lane_s[j - 1]
            if c < best[j]:
                best[j], cut[j] = c, i - 1
    edges = []
    j = m
    while j > 0:
        edges.append(uniq[j - 1])
        j = cut[j]
    return edges[::-1]
