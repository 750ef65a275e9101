"""Measured refinement of the planner's choice, its on-disk cache, and the
calibration of the machine model from measured records (the reference's
``plan/autotune.py``).

The analytic model (``plan.model``) ranks candidates by their counts on a
machine entry, and the card disagrees where the counts tie: at A =
32768², r = 512 the ``cuda_fused`` sketch and ``local_torch`` both price
at their FLOPs, and ``torch.matmul`` is the faster body.  ``autotune``
times the candidates on a synthetic input of the plan's shape and returns
the plan rebuilt around the measured winner, with ``measured_seconds``
set and its predictions rescored for the variant that won.

What it sweeps (``_measurable_candidates``): every executable one-card
candidate; at P > 1 the ``top_k`` executable Alg. 1 grids, or the joint
(p, q) pairs of the two-grid Nyström, by predicted network time, then
predicted seconds; a stream's ``chunk_rows`` at half, once and twice the
plan's.  There is no block sweep: the port's kernels take their tiles and
splits from ``sketch_fwd_plan`` / ``sketch_t_plan``.  A candidate is timed
only where it fits the device (``_fits``): its device-memory bytes
(operands, result, the kernels' Omega scratch and split-K work buffer, the
plain path's materialized Omega) against the free memory of the card
(``machine.hbm_bytes`` on the CPU), and each of its kernels' shared
memory a block (``kernel_smem_bytes``) against ``machine.smem_bytes``.
What does not fit is named in the returned plan's ``notes``.

A plan on P > 1 ranks is tuned by every rank of the default process
group together, so that all of them return the same plan: rank 0 alone
reads the cache and the shipped decisions and broadcasts what it found,
each candidate's seconds are the slowest rank's (an all-reduce with MAX),
and rank 0 alone writes the cache, before a barrier.

Decisions persist in a JSON cache keyed by ``(device kind, task, shape
bucket, dtype, P)``, the bucket rounding every dim up to a power of two;
a stored decision is revalidated against the exact dims before use.  The
cache is versioned and written atomically (a temporary file, then
``os.replace``).  ``PRESET_ENTRIES`` ships decisions measured on an H100
as a read-only second level, consulted on a cache miss.

The timer is injectable (``timer=lambda fn: seconds``), so tests tune
deterministically without a clock.  ``default_timer`` times with CUDA
events on the card and the host clock on the CPU.

Calibration: a record is one measured call beside its analytic counts
(``words``, ``messages``, ``flops``, ``hbm_words``, ``itemsize``,
``seconds``; the card's records also carry ``device_kind`` and the power
limit).  :func:`calibrate_machine_model` least-squares fits the network
terms of a :class:`~repro_torch.plan.model.MachineModel` to them;
``save_sweep`` / ``load_sweep`` keep them as JSON.  ``chip_smoke.py``
writes the card's records (phases 3-4 and 12-16) to
``build/repro_torch/cost_sweep.json``; ``h100_sweep.json`` beside this
module is the committed set that the H100 entry's ``alpha`` and
``byte_bw`` are the fit of.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import sys
import tempfile
import time
import types
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.grid import (alg2_two_grid_executable,
                                   factorizations_3d, two_grid_axis_split)
from repro_torch.core.kinds import DENSE_KINDS, SPARSE_KINDS
from repro_torch.kernels.sketch_matmul import (SKETCH_T_KERNELS,
                                               kernel_smem_bytes,
                                               sketch_fwd_kernels,
                                               sketch_fwd_plan,
                                               sketch_t_plan)
from . import model as M
from .planner import Plan, _alg1_executable, _itemsize

CACHE_VERSION = 2

#: The card records behind the H100 entry's network terms.
H100_SWEEP = pathlib.Path(__file__).with_name("h100_sweep.json")

#: The variants each task's plans can name in the port.
VARIANTS = {"sketch": ("alg1", "cuda_fused", "local_torch", "local_sparse"),
            "nystrom": ("alg2_no_redist", "alg2_redist", "alg2_bound_driven",
                        "alg2_bound_driven_fused", "cuda_fused",
                        "local_torch"),
            "stream": ("stream_local", "stream_sharded", "stream_sparse")}
_SPARSE_VARIANTS = ("local_sparse", "stream_sparse")
_INPUT_CHUNK = 1 << 22        # elements of A drawn by one generator


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

class AutotuneCache:
    """Versioned JSON cache of tuning decisions; counts hits and misses."""

    def __init__(self, path):
        self.path = str(path)
        self.hits = 0
        self.misses = 0
        self._entries: Dict[str, dict] = {}
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    data = json.load(f)
                if data.get("version") == CACHE_VERSION:
                    self._entries = data.get("entries", {})
            except (OSError, ValueError):
                pass  # an unreadable or stale cache is an empty cache

    def get(self, key: str) -> Optional[dict]:
        hit = self._entries.get(key)
        self.count(hit is not None)
        return hit

    def count(self, hit: bool) -> None:
        """Count one lookup (a rank past 0 of a multi-rank plan counts the
        outcome of rank 0's)."""
        if hit:
            self.hits += 1
        else:
            self.misses += 1

    def put(self, key: str, value: dict):
        self._entries[key] = value
        self._flush()

    def pop(self, key: str) -> Optional[dict]:
        """Drop one entry, so that the next ``autotune`` at ``key``
        measures again (``obs.report.revalidate_autotune`` pops the keys
        of the comm-ledger sites whose words drifted).  Returns it, or
        None when the key was absent (nothing is written then)."""
        hit = self._entries.pop(key, None)
        if hit is not None:
            self._flush()
        return hit

    def _flush(self):
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_tune_")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"version": CACHE_VERSION,
                           "entries": self._entries}, f, indent=1)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def __len__(self):
        return len(self._entries)


def shape_bucket(x: int) -> int:
    """Round up to the next power of two (>= 1)."""
    return 1 << max(0, int(x - 1).bit_length())


def cache_key(plan: Plan, device_kind: Optional[str] = None,
              device=None) -> str:
    """``device kind / task / pow2-bucketed dims / dtype / P``; the kind is
    ``device_kind_tag(device)`` unless given."""
    kind = device_kind or M.device_kind_tag(device)
    dims = "x".join(str(shape_bucket(d)) for d in plan.dims)
    return f"{kind}/{plan.task}/{dims}/{plan.dtype}/P{plan.n_procs}"


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def default_timer(fn: Callable[[], object], warmup: int = 1, iters: int = 3,
                  device=None) -> float:
    """Median seconds of ``iters`` calls of ``fn()`` after ``warmup``.

    On the card (``device`` None or CUDA) each call is timed with CUDA
    events on the current stream, which is synchronized before they are
    read, so ``fn`` may return a tensor or a stream accumulator; on the
    CPU with the host clock."""
    from repro_torch.core.rng import resolve_device
    device = resolve_device(device)
    ts = []
    if device.type == "cuda":
        with torch.cuda.device(device):
            for _ in range(warmup):
                fn()
            torch.cuda.synchronize(device)
            for _ in range(iters):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                fn()
                t1.record()
                t1.synchronize()
                ts.append(t0.elapsed_time(t1) * 1e-3)
    else:
        for _ in range(warmup):
            fn()
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def _synthetic_input(plan: Plan, device) -> torch.Tensor:
    """The plan's full A (n1 x n2, or n x n for Nyström) in its dtype,
    standard normal (not zeros: a zero fast path must not skew a time).
    Rows are drawn on the CPU in chunks of about ``_INPUT_CHUNK``
    elements, chunk c from a ``torch.Generator`` seeded ``c``, so every
    rank and every device gets the same A; each chunk is moved to
    ``device`` as it is drawn."""
    from concurrent.futures import ThreadPoolExecutor
    n1, n2 = ((plan.dims[0], plan.dims[0]) if plan.task == "nystrom"
              else (plan.dims[0], plan.dims[1]))
    dtype = getattr(torch, plan.dtype)
    rows = max(1, _INPUT_CHUNK // max(n2, 1))
    starts = list(range(0, n1, rows))
    A = torch.empty((n1, n2), dtype=dtype, device=device)

    def draw(c: int) -> torch.Tensor:
        g = torch.Generator().manual_seed(c)
        r0 = starts[c]
        return torch.randn((min(rows, n1 - r0), n2), generator=g).to(dtype)
    workers = max(1, min(len(starts), torch.get_num_threads()))
    with ThreadPoolExecutor(workers) as pool:
        for w0 in range(0, len(starts), workers):
            chunks = pool.map(draw, range(w0, min(w0 + workers,
                                                  len(starts))))
            for c, chunk in zip(range(w0, len(starts)), chunks):
                A[starts[c]:starts[c] + chunk.shape[0]].copy_(chunk)
    return A


# ---------------------------------------------------------------------------
# the fit: device memory and shared memory (the reference's _vmem_fits)
# ---------------------------------------------------------------------------

def _variant_kind(plan: Plan, variant: str) -> str:
    """The Omega kind ``variant`` draws: a sparse variant the plan's sparse
    kind (CountSketch for a dense request, as the planner substitutes),
    a dense one the kind asked for."""
    asked = plan.requested_kind or plan.kind
    if variant in _SPARSE_VARIANTS and asked not in SPARSE_KINDS:
        return "countsketch"
    return asked


def _sketch_l(plan: Plan) -> int:
    n1, _, r = plan.dims
    return plan.sketch_l if plan.sketch_l is not None \
        else min(2 * r + 1, n1)


def _fwd_bytes(m: int, n: int, K: int) -> int:
    """A ``sketch_fwd`` call's Omega scratch and work buffer."""
    if min(m, n, K) <= 0:
        return 0
    p = sketch_fwd_plan(m, n, K)
    return p["scratch_bytes"] + p["work_bytes"]


def _t_bytes(m: int, n: int, K: int) -> int:
    """A ``sketch_t`` call's Omega scratch and work buffer."""
    if min(m, n, K) <= 0:
        return 0
    p = sketch_t_plan(m, n, K)
    return p["scratch_bytes"] + p["work_bytes"]


def _alg1_bytes(n1: int, n2: int, r: int, grid, isz: int) -> int:
    """One rank's Alg. 1 buffers past the full A: its A block, the
    gathered panel, the body's scratch and work, the partial and its B
    block."""
    p1, p2, p3 = grid
    P = p1 * p2 * p3
    return (n1 * n2 // P * isz + n1 // p1 * (n2 // p2) * isz
            + _fwd_bytes(n1 // p1, r // p3, n2 // p2)
            + n1 // p1 * (r // p3) * 4 + n1 * r // P * isz)


def device_bytes(plan: Plan) -> int:
    """The device memory one rank holds at once to execute ``plan`` on its
    synthetic input, estimated from its buffers: the full A every rank is
    given, the operands and results of its bodies, the kernels' Omega
    scratch and split-K work buffers (``sketch_fwd_plan``,
    ``sketch_t_plan``), the plain path's materialized Omega, and a
    stream's accumulators."""
    isz = _itemsize(plan.dtype)
    v = plan.variant
    if plan.task == "nystrom":
        n, r = plan.dims
        A = n * n * isz
        if v == "cuda_fused":
            return (A + _fwd_bytes(n, r, n) + n * r * isz
                    + _t_bytes(r, r, n) + r * r * isz)
        if v == "local_torch":
            return A + 2 * n * r * isz + r * r * isz
        p, q = plan.grid, plan.q_grid or plan.grid
        P = p[0] * p[1] * p[2]
        return (A + _alg1_bytes(n, n, r, p, isz) + 2 * n * r // P * isz
                + n // q[0] * (r // q[2]) * isz
                + _t_bytes(r // q[1], r // q[2], n // q[0])
                + 2 * r * r // P * 4)
    n1, n2, r = plan.dims
    A = n1 * n2 * isz
    if plan.task == "sketch":
        if v == "alg1":
            return A + _alg1_bytes(n1, n2, r, plan.grid, isz)
        if v == "cuda_fused":
            return A + _fwd_bytes(n1, r, n2) + n1 * r * isz
        if v == "local_torch":
            return A + n2 * r * isz + n1 * r * isz
        return 2 * A + n1 * r * isz      # local_sparse: A * value, then B
    k = plan.chunk_rows or n1
    l = _sketch_l(plan)
    p1, p2, p3 = plan.grid if v == "stream_sharded" else (1, 1, 1)
    acc = (n1 // (p1 * p2) * (r // p3)
           + (l * (n2 // (p2 * p3)) if plan.corange else 0)) * 4
    slab = (_fwd_bytes(k, r // p3, n2 // p2) + k * (r // p3) * 4
            + (_t_bytes(l, n2 // (p2 * p3), k) if plan.corange else 0))
    if v == "stream_sparse":
        # the slab's COO payload from a dense slab: every entry stored,
        # an int64 row and column and a value, then its CSR copies
        slab += 2 * k * n2 * (16 + isz)
    elif p3 > 1:
        slab += k * (n2 // p2) * isz              # the gathered slab
    return A + acc + slab


def _kernels_of(plan: Plan) -> Tuple[str, ...]:
    """The CUDA kernels ``plan``'s variant launches on the card."""
    v = plan.variant
    if v == "local_torch":
        return ("gen_omega_kernel",)
    if v == "local_sparse":
        return ()                     # index_add_: no kernel of the port
    if plan.task == "sketch":
        p3 = plan.grid[2] if v == "alg1" else 1
        return sketch_fwd_kernels(plan.dims[2] // p3)
    if plan.task == "nystrom":
        p3 = plan.grid[2] if plan.grid else 1
        return sketch_fwd_kernels(plan.dims[1] // p3) + SKETCH_T_KERNELS
    if v == "stream_sparse":
        return ("gen_omega_kernel", "sparse_fold_rows_kernel",
                "sparse_fold_tile_kernel")
    p3 = plan.grid[2] if v == "stream_sharded" else 1
    out = sketch_fwd_kernels(plan.dims[2] // p3)
    if plan.corange:
        out += SKETCH_T_KERNELS
    if v == "stream_sharded":
        out += ("fold_rows_kernel",)
    return out


def _fits(plan: Plan, machine: M.MachineModel,
          free_bytes: float) -> Optional[str]:
    """None when ``plan`` fits the device, else why it does not: its
    :func:`device_bytes` against ``free_bytes``, each kernel's shared
    memory a block against ``machine.smem_bytes``."""
    need = device_bytes(plan)
    if need > free_bytes:
        return (f"needs {need} bytes of device memory, {int(free_bytes)} "
                f"free")
    smem = kernel_smem_bytes()
    for name in _kernels_of(plan):
        b = sum(smem[name])
        if b > machine.smem_bytes:
            return (f"{name} needs {b} bytes of shared memory a block, "
                    f"the machine has {machine.smem_bytes}")
    return None


def _free_bytes(device: torch.device, machine: M.MachineModel) -> float:
    """Device memory a candidate may take: the card's free memory plus
    what PyTorch's allocator holds unused, or ``machine.hbm_bytes`` off
    the card."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return float(free + torch.cuda.memory_reserved(device)
                     - torch.cuda.memory_allocated(device))
    return float(machine.hbm_bytes)


def _describe(plan: Plan) -> str:
    where = f" grid={plan.grid}" if plan.grid else ""
    whereq = f" q={plan.q_grid}" if plan.q_grid else ""
    chunk = f" chunk_rows={plan.chunk_rows}" if plan.chunk_rows else ""
    return f"{plan.variant}{where}{whereq}{chunk}"


# ---------------------------------------------------------------------------
# candidate expansion (what a measured pass sweeps)
# ---------------------------------------------------------------------------

def _rank_key(c: M.Cost, machine: M.MachineModel, isz: int) -> tuple:
    """Order of the grids a sweep keeps: network seconds, then seconds.
    Every grid of one P does the same FLOPs, so the words and hops that
    differ rank first, and the device-memory words of the port's bodies
    (its Omega scratch and work buffers) only break ties."""
    net = c.words * isz / machine.byte_bw + c.messages * machine.alpha
    return (net, c.seconds(machine, isz))


def _measurable_candidates(plan: Plan, machine: M.MachineModel,
                           top_k: int) -> List[Plan]:
    """The plan variants to time, in the reference's order: at P > 1 the
    ``top_k`` executable Alg. 1 grids, or for a two-grid Nyström the top
    joint (p, q) pairs (fused pairs only where one rank order serves both
    grids), by :func:`_rank_key`; a stream's executable candidates at
    ``chunk_rows`` k/2, k and 2k, cut to ``max(2·top_k, 3)``; otherwise
    the ``top_k`` executable candidates as they are.  Where grids tie on
    network time, the port's device-memory words and the reference's
    break the tie each its own way, so the two orders can differ there
    (tiny shapes on the ``cpu`` entry, whose memory term then binds)."""
    isz = _itemsize(plan.dtype)
    out: List[Plan] = []

    def add(variant, grid=None, q_grid=None, chunk_rows=None):
        out.append(dataclasses.replace(
            plan, variant=variant, grid=grid, q_grid=q_grid,
            chunk_rows=chunk_rows if chunk_rows else plan.chunk_rows,
            kind=_variant_kind(plan, variant), executable=True,
            measured_seconds=None, notes=()))

    if plan.task == "sketch" and plan.n_procs > 1:
        n1, n2, r = plan.dims
        scored = []
        for g in factorizations_3d(plan.n_procs):
            if _alg1_executable(n1, n2, r, g):
                scored.append((_rank_key(M.alg1_cost(n1, n2, r, g),
                                         machine, isz), g))
        scored.sort(key=lambda t: t[0])
        for _, g in scored[:top_k]:
            add("alg1", grid=g)
        return out

    if plan.task == "stream":
        k0 = plan.chunk_rows or plan.dims[0]
        for k in sorted({max(1, k0 // 2), k0, min(plan.dims[0], k0 * 2)}):
            for cand in plan.candidates:
                if cand.executable:
                    add(cand.variant, grid=cand.grid, chunk_rows=k)
        return out[: max(top_k * 2, 3)]

    for cand in [c for c in plan.candidates if c.executable][:top_k]:
        if cand.variant in ("alg2_bound_driven", "alg2_bound_driven_fused"):
            n, r = plan.dims
            fused = cand.variant == "alg2_bound_driven_fused"
            cost_fn = M.alg2_fused_cost if fused else M.alg2_cost
            facs = list(factorizations_3d(plan.n_procs))
            scored_pq = []
            for pg in facs:
                for qg in facs:
                    if not alg2_two_grid_executable(n, r, pg, qg):
                        continue
                    if fused and two_grid_axis_split(pg, qg) is None:
                        continue
                    scored_pq.append((_rank_key(cost_fn(n, r, pg, qg),
                                                machine, isz), pg, qg))
            scored_pq.sort(key=lambda t: t[0])
            for _, pg, qg in scored_pq[:top_k]:
                add(cand.variant, grid=pg, q_grid=qg)
        else:
            add(cand.variant, grid=cand.grid, q_grid=cand.q_grid)
    return out


def _fitting(cands: Sequence[Plan], machine: M.MachineModel,
             free_bytes: float):
    """(the candidates that fit, a note for each one left out)."""
    kept, notes = [], []
    for c in cands:
        why = _fits(c, machine, free_bytes)
        if why is None:
            kept.append(c)
        else:
            notes.append(f"{_describe(c)} not timed: {why}")
    return kept, notes


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def _group(plan: Plan) -> bool:
    """Whether ``plan`` is tuned by the ranks of the default process group
    together (P > 1 under an initialized group)."""
    if plan.n_procs <= 1:
        return False
    return dist.is_available() and dist.is_initialized()


def _broadcast(obj):
    """Rank 0's ``obj`` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _reduce(x: float, op: str) -> float:
    """``x`` reduced over the ranks with ``op`` ("MIN" or "MAX")."""
    t = torch.tensor([x], dtype=torch.float64)
    dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
    return float(t.item())


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

def _measure(plan: Plan, machine: M.MachineModel, timer, top_k: int,
             seed: int, device, together: bool):
    """Time the sweep of ``plan`` that fits the device: ``[(seconds,
    candidate)]`` in the sweep's order (each the slowest rank's when
    ``together``) and the notes of what was left out."""
    from repro_torch.core.rng import resolve_device
    device = resolve_device(device)
    timer = timer or (lambda fn: default_timer(fn, device=device))
    free = _free_bytes(device, machine)
    if together:
        free = _reduce(free, "MIN")
    cands, notes = _fitting(_measurable_candidates(plan, machine, top_k),
                            machine, free)
    A = None
    out = []
    for cand in cands:
        if A is None:
            A = _synthetic_input(plan, device)
        secs = float(timer(lambda c=cand: c.execute(A, seed=seed,
                                                    device=device)))
        if together:
            secs = _reduce(secs, "MAX")
        out.append((secs, cand))
    del A
    return out, notes


def autotune(plan: Plan, *,
             cache=None,
             timer: Optional[Callable[[Callable[[], object]], float]] = None,
             top_k: int = 3, seed: int = 0, device=None,
             machine: Optional[M.MachineModel] = None,
             device_kind: Optional[str] = None,
             presets: Optional[Dict[str, dict]] = None,
             records: Optional[List[dict]] = None) -> Plan:
    """Return ``plan`` refined by measurement on ``device`` (None: the
    card).

    cache   : an :class:`AutotuneCache`, a path to make one at, or None
              for no persistence.
    timer   : maps a nullary closure to seconds (default
              :func:`default_timer` on ``device``).
    presets : a read-only second-level cache of shipped decisions
              (default :data:`PRESET_ENTRIES`; ``{}`` turns it off),
              consulted only on a cache miss; a preset hit seeds the
              cache.
    records : a list that receives one record a timed candidate
              (:func:`sweep_records`) for the machine model's calibration.

    A cache hit, revalidated against the exact dims, skips measuring and
    rebuilds the plan from the stored decision; a preset hit does the
    same; a miss times the sweep, stores the winner and returns it with
    ``measured_seconds`` set.  A plan on P > 1 ranks is tuned by every
    rank of the default process group together and the same plan comes
    back on each."""
    together = _group(plan)
    lead = not together or dist.get_rank() == 0
    if isinstance(cache, (str, os.PathLike)):
        cache = AutotuneCache(cache) if lead else None
    machine = machine or M.probe_machine(device)
    presets = PRESET_ENTRIES if presets is None else presets

    key = cache_key(plan, device_kind, device)
    found, looked = None, None         # (where, entry); rank 0's lookup
    if lead:
        hit = cache.get(key) if cache is not None else None
        looked = hit is not None
        if hit is not None and _plan_from_entry(plan, hit) is not None:
            found = ("cache", hit)
        elif presets.get(key) is not None \
                and _plan_from_entry(plan, presets[key]) is not None:
            found = ("preset", presets[key])
    if together:
        found, looked = _broadcast((found, looked))
        if not lead and cache is not None and looked is not None:
            cache.count(looked)
    if found is not None:
        where, entry = found
        if where == "preset" and cache is not None and lead:
            cache.put(key, dict(entry))
        if together:
            dist.barrier()
        return _rescore(_plan_from_entry(plan, entry), machine)

    timed, notes = _measure(plan, machine, timer, top_k, seed, device,
                            together)
    if records is not None:
        records.extend(_record(c, machine, s) for s, c in timed)
    if not timed:
        return dataclasses.replace(plan, notes=tuple(notes) + (
            "nothing fits the device: the analytic choice stands",))
    secs, winner = min(timed, key=lambda t: t[0])
    tuned = _rescore(dataclasses.replace(
        winner, measured_seconds=secs, notes=tuple(notes)), machine)
    if cache is not None and lead:
        cache.put(key, _entry_from_plan(tuned))
    if together:
        dist.barrier()
    return tuned


def _rescore(plan: Plan, machine: M.MachineModel) -> Plan:
    """The plan's predicted counts and seconds recomputed for its (tuned)
    variant, grid and chunk, so that the bound audit and ``explain``
    describe what was chosen, not the analytic favourite."""
    if plan.task == "sketch":
        n1, n2, r = plan.dims
        if plan.variant == "alg1" and plan.grid:
            c = M.alg1_cost(n1, n2, r, plan.grid)
        elif plan.variant == "local_torch":
            c = M.local_torch_cost(n1, n2, r)
        elif plan.variant == "local_sparse":
            c = M.sparse_sketch_cost(n1, n2, r, plan.nnz, (1, 1, 1),
                                     plan.kind)
        else:
            c = M.local_cost(n1, n2, r)
    elif plan.task == "nystrom":
        n, r = plan.dims
        if plan.variant == "alg2_bound_driven_fused" and plan.grid:
            c = M.alg2_fused_cost(n, r, plan.grid, plan.q_grid or plan.grid)
        elif plan.variant.startswith("alg2") and plan.grid:
            c = M.alg2_cost(n, r, plan.grid, plan.q_grid or plan.grid)
        elif plan.variant == "local_torch":
            c = M.nystrom_local_torch_cost(n, r)
        else:
            c = M.nystrom_local_cost(n, r)
    else:
        n1, n2, r = plan.dims
        k = plan.chunk_rows or n1
        l = _sketch_l(plan)
        n_upd = math.ceil(n1 / k)
        if plan.variant == "stream_sparse":
            per = M.sparse_stream_update_cost(k, n2, r, l, plan.nnz / n_upd,
                                              (1, 1, 1), plan.corange,
                                              plan.kind)
        else:
            grid = plan.grid if plan.variant == "stream_sharded" \
                else (1, 1, 1)
            per = M.stream_update_cost(k, n2, r, l, grid, plan.corange)
        c = M.Cost(words=per.words * n_upd, messages=per.messages * n_upd,
                   flops=per.flops * n_upd, hbm_words=per.hbm_words * n_upd)
    return dataclasses.replace(
        plan, predicted_words=c.words, predicted_flops=c.flops,
        predicted_hbm_words=c.hbm_words,
        predicted_seconds=c.seconds(machine, _itemsize(plan.dtype)))


def _entry_from_plan(plan: Plan, source: str = "measured") -> dict:
    return {"variant": plan.variant,
            "grid": list(plan.grid) if plan.grid else None,
            "q_grid": list(plan.q_grid) if plan.q_grid else None,
            "chunk_rows": plan.chunk_rows,
            "source": source,
            "seconds": plan.measured_seconds}


def _record(plan: Plan, machine: M.MachineModel, seconds: float) -> dict:
    """One calibration sample: the candidate's analytic counts (rescored
    for what was timed) beside its measured seconds."""
    scored = _rescore(plan, machine)
    return {"task": plan.task, "dims": list(plan.dims),
            "P": plan.n_procs, "variant": plan.variant,
            "grid": list(plan.grid) if plan.grid else None,
            "q_grid": list(plan.q_grid) if plan.q_grid else None,
            "chunk_rows": plan.chunk_rows,
            "words": scored.predicted_words,
            "messages": _messages_of(scored),
            "flops": scored.predicted_flops,
            "hbm_words": scored.predicted_hbm_words,
            "itemsize": _itemsize(plan.dtype),
            "seconds": seconds}


def _messages_of(plan: Plan) -> float:
    """Latency hops of the plan's variant (re-derived from the model)."""
    if plan.task == "sketch" and plan.variant == "alg1" and plan.grid:
        return M.alg1_cost(*plan.dims, plan.grid).messages
    if plan.task == "nystrom" and plan.grid:
        cost_fn = (M.alg2_fused_cost
                   if plan.variant == "alg2_bound_driven_fused"
                   else M.alg2_cost)
        return cost_fn(*plan.dims, plan.grid,
                       plan.q_grid or plan.grid).messages
    if plan.task == "stream" and plan.variant != "stream_sparse":
        n1 = plan.dims[0]
        k = plan.chunk_rows or n1
        grid = plan.grid if plan.variant == "stream_sharded" else (1, 1, 1)
        per = M.stream_update_cost(k, plan.dims[1], plan.dims[2],
                                   _sketch_l(plan), grid, plan.corange)
        return per.messages * math.ceil(n1 / k)
    return 0.0


def _plan_from_entry(plan: Plan, entry: dict) -> Optional[Plan]:
    """Rebuild a plan from a stored decision; None where it does not apply
    to this plan's exact dims (a pow2 bucket collision) or names a variant
    the port does not run (the reference's ``pallas_fused`` /
    ``local_xla``).  ``backend`` and ``blocks`` keys are ignored."""
    variant = entry.get("variant")
    if variant not in VARIANTS.get(plan.task, ()):
        return None
    grid = tuple(entry["grid"]) if entry.get("grid") else None
    q_grid = tuple(entry["q_grid"]) if entry.get("q_grid") else None
    P = plan.n_procs
    kind = _variant_kind(plan, variant)
    distributed = variant.startswith("alg") or variant == "stream_sharded"
    if distributed != (P > 1):
        return None
    if variant == "cuda_fused" and kind not in DENSE_KINDS:
        return None
    if variant in _SPARSE_VARIANTS and plan.nnz is None:
        return None
    if plan.task in ("sketch", "stream"):
        n1, n2, r = plan.dims
        if distributed and (grid is None or math.prod(grid) != P
                            or not _alg1_executable(n1, n2, r, grid)):
            return None
    elif distributed:
        n, r = plan.dims
        if variant in ("alg2_bound_driven", "alg2_bound_driven_fused"):
            if grid is None or q_grid is None or math.prod(grid) != P \
                    or not alg2_two_grid_executable(n, r, grid, q_grid):
                return None
            if variant == "alg2_bound_driven_fused" \
                    and two_grid_axis_split(grid, q_grid) is None:
                return None
        elif n % P or r % P or P > n:
            return None
    return dataclasses.replace(
        plan, variant=variant, grid=grid, q_grid=q_grid,
        chunk_rows=entry.get("chunk_rows"), kind=kind,
        measured_seconds=entry.get("seconds"), executable=True, notes=())


# ---------------------------------------------------------------------------
# Shipped decisions — a read-only second-level cache.
#
# Keys use ``cache_key``'s format.  No entry is a TPU's: every one was
# measured by ``autotune`` on an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit (nvidia-smi --query-gpu=name,power.limit), in chip_smoke.py phase
# 18, and carries that run's median seconds; a local measurement
# overwrites one in the writable cache.
# ---------------------------------------------------------------------------

def _measured(variant, seconds, grid=None, q_grid=None, chunk_rows=None):
    return {"variant": variant, "grid": grid, "q_grid": q_grid,
            "chunk_rows": chunk_rows, "source": "measured",
            "seconds": seconds}


_H100 = "NVIDIA_H100_80GB_HBM3"

PRESET_ENTRIES: Dict[str, dict] = {
    # one card, A = 32768², r = 512: torch.matmul on a gen_omega Omega
    # beat the sketch_fwd kernel (21.86 against 26.59 ms) and the kernel
    # pair (22.14 against 27.13 ms); the stream of eight 4096-row slabs ran
    # fastest in 8192-row slabs (84.25 ms; 87.40 at 4096, 117.72 at 2048)
    f"{_H100}/sketch/32768x32768x512/float32/P1":
        _measured("local_torch", 0.021858495712280275),
    f"{_H100}/nystrom/32768x512/float32/P1":
        _measured("local_torch", 0.02214121627807617),
    f"{_H100}/stream/32768x32768x512/float32/P1":
        _measured("stream_local", 0.08425484466552735, chunk_rows=8192),
    # four gloo ranks sharing the card, the slowest rank's time: Alg. 1 on
    # (4,1,1), 0 words (20.27 ms; (2,2,1) 108.53, (1,4,1) 266.04); the
    # two-grid pair ((4,1,1), (4,1,1)), 196,608 words (40.00 ms; the 1-D
    # no_redist, the same words, 42.34)
    f"{_H100}/sketch/32768x32768x512/float32/P4":
        _measured("alg1", 0.02026531219482422, grid=[4, 1, 1]),
    f"{_H100}/nystrom/32768x512/float32/P4":
        _measured("alg2_bound_driven_fused", 0.039999679565429686,
                  grid=[4, 1, 1], q_grid=[4, 1, 1]),
}


# ---------------------------------------------------------------------------
# Machine-model calibration from measured records
# ---------------------------------------------------------------------------

def sweep_records(plan: Plan, *, timer: Optional[Callable] = None,
                  top_k: int = 4, seed: int = 0, device=None,
                  machine: Optional[M.MachineModel] = None) -> List[dict]:
    """Time the candidate sweep of ``plan`` that fits the device and
    return one record a candidate (analytic words, messages, FLOPs and
    device-memory words beside the measured seconds), the JSON that
    :func:`calibrate_machine_model` fits.  Never touches a cache; the
    timer is injectable as :func:`autotune`'s."""
    machine = machine or M.probe_machine(device)
    timed, _ = _measure(plan, machine, timer, top_k, seed, device,
                        _group(plan))
    return [_record(c, machine, s) for s, c in timed]


def save_sweep(records: Sequence[dict], path) -> None:
    """Persist measured records as the calibration JSON."""
    with open(path, "w") as f:
        json.dump({"version": CACHE_VERSION, "records": list(records)}, f,
                  indent=1)


def load_sweep(path) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return list(data.get("records", []))


def calibrate_machine_model(records: Sequence[dict],
                            base: Optional[M.MachineModel] = None,
                            name: Optional[str] = None) -> M.MachineModel:
    """Fit a :class:`MachineModel`'s network terms from measured residuals.

    The cost model predicts ``t = max(flops/F, hbm·isz/H) + words·isz/B +
    msgs·alpha``.  Holding the base entry's compute and memory rates (F,
    H) fixed, the residual ``t_meas - max(flops/F, hbm·isz/H)`` of each
    record is linear in (1/B, alpha): a two-parameter least-squares fit.
    Records with zero words and zero messages only pin the compute floor
    and drop out.  A fitted value that is not positive keeps the base's;
    with no informative record both base terms are kept."""
    import numpy as np
    base = base or M.probe_machine()
    rows, rhs = [], []
    for rec in records:
        isz = float(rec.get("itemsize", 4))
        local = max(rec["flops"] / base.flop_rate,
                    rec["hbm_words"] * isz / base.hbm_bw)
        resid = rec["seconds"] - local
        w = rec["words"] * isz
        m = rec.get("messages", 0.0)
        if w == 0.0 and m == 0.0:
            continue
        rows.append([w, m])
        rhs.append(resid)
    if not rows:
        return dataclasses.replace(
            base, name=name or f"{base.name}_calibrated")
    X = np.asarray(rows, float)
    y = np.asarray(rhs, float)
    sol, *_ = np.linalg.lstsq(X, y, rcond=None)
    inv_bw, alpha = float(sol[0]), float(sol[1])
    byte_bw = base.byte_bw if inv_bw <= 0.0 else 1.0 / inv_bw
    alpha = base.alpha if alpha <= 0.0 else alpha
    return dataclasses.replace(
        base, name=name or f"{base.name}_calibrated",
        byte_bw=byte_bw, alpha=alpha)


class _CallableModule(types.ModuleType):
    """This module, callable as :func:`autotune`: the package exports the
    module under that name (``repro_torch.plan.autotune``), so that a call
    tunes, as the reference's ``repro.plan.autotune`` does, and the
    module's other names (``H100_SWEEP``, ``CACHE_VERSION``) stay
    reachable from the same name."""

    def __call__(self, *args, **kwargs):
        return autotune(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule
