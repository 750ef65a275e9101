"""Cost-model-driven execution planner for sketch / Nyström / stream
dispatch (the reference's ``plan/planner.py``).

``plan_sketch`` / ``plan_nystrom`` / ``plan_stream`` enumerate every
variant the port can execute for the given (shape, P, dtype), price each
with the costs of :mod:`repro_torch.plan.model` on a :class:`MachineModel`
(``probe_machine()`` by default: the H100 entry on the card), compare the
winner against the paper's lower bound (Theorems 2/3), and return a
:class:`Plan` whose ``execute`` makes exactly the call a user would make,
so its result is bitwise that call's on the same device.

Planner invariants (``tests/test_torch_planner.py``, as the reference's):

  * predicted words are never below the Theorem 2/3 lower bound;
  * when a distributed variant wins, its words equal the closed forms
    ``alg1_bandwidth_words`` / ``alg2_bandwidth_words`` exactly (the fused
    two-grid form: ``alg2_fused_cost``);
  * in the Theorem-2 regime 1 (P <= n1) the planner picks the
    zero-communication grid (P, 1, 1);
  * the Alg.-1 grid agrees with ``core.grid.select_matmul_grid`` whenever
    that grid is executable (divisibility), and otherwise is the cheapest
    executable factorization of P.

What differs from the reference, and why:

  * The one-card variants are ``cuda_fused`` (``ops.sketch_matmul`` /
    ``ops.nystrom_fused``: the ``sketch_fwd`` kernel, then ``sketch_t``,
    each drawing its Omega slab into a scratch inside the call; the
    reference's ``pallas_fused``) and ``local_torch``
    (``sketch_reference`` / ``nystrom_reference``: Omega materialized, on
    the card by the ``gen_omega`` kernel, then ``torch.matmul``; the
    reference's ``local_xla``, its own non-Pallas path, and not the plain
    version of any kernel).  ``cuda_fused`` is listed first, so a tie in
    the ranking goes to the kernel; it draws the dense kinds only.
  * No ``backend`` field: the reference prices every distributed variant
    twice, once per jnp / pallas body.  The port has one body a device
    (``plan/model.py``), so each variant appears once.
  * No ``blocks`` field: those are the Pallas MXU tiles.  The port's
    kernels choose their own tiles (``sketch_fwd_plan``,
    ``sketch_t_plan``).
  * No ``allow_pallas`` argument and no "needs TPU" candidate: nothing in
    the port needs one.
  * ``P=None`` is the default process group's world size (1 without one).
  * The P > 1 Nyström pick can differ.  Every candidate's words,
    messages and FLOPs are the reference's; its device-memory words price
    the port's bodies.  At q = (1, 1, P) the second stage's ``sketch_t``
    draws its Omega slab into a K × ceil4(m) scratch, whatever the
    output's width (``sketch_t_plan(4096, 1, 65536)`` allocates
    1,073,741,824 bytes for a 4096 × 1 output), and that price makes the
    fused candidate memory-bound.  Where the reference picks
    ``alg2_bound_driven_fused`` on q = (1, 1, P) the port can pick
    ``alg2_no_redist``, which moves more words: at (n, r, P) = (256, 128,
    32) 15,872 against 992, at (4096, 256, 256) 65,280 against 4,080, at
    (8192, 4096, 4096) 16,773,120 against 8,190
    (``tests/test_torch_planner.py``, the ``f1`` cases).  A ``sketch_t``
    path for thin outputs with no scratch would move these picks back.

The ranking is analytic; ``plan.autotune`` refines it with times measured
on the device.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.grid import (MatmulGrid, factorizations_3d,
                                   select_matmul_grid, select_nystrom_grids,
                                   select_two_grid_executable,
                                   two_grid_axis_split)
from repro_torch.core.kinds import DENSE_KINDS, SPARSE_KINDS
from repro_torch.core.lower_bounds import (matmul_lower_bound, matmul_regime,
                                           nystrom_lower_bound,
                                           nystrom_regime)
from repro_torch.models.api import param_leaves, unflatten_like
from . import model as M


def _dtype_name(dtype) -> str:
    """``torch.float32`` or ``"float32"`` -> ``"float32"``."""
    t = dtype if isinstance(dtype, torch.dtype) else getattr(
        torch, str(dtype), None)
    if not isinstance(t, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return str(t).removeprefix("torch.")


def _itemsize(dtype_name: str) -> int:
    return getattr(torch, dtype_name).itemsize


def _world(P: Optional[int]) -> int:
    if P is None:
        from repro_torch.parallel.grad_compress import world_size
        return world_size()
    return int(P)


# ---------------------------------------------------------------------------
# Candidates and the Plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Candidate:
    """One priced dispatch option; ``executable=False`` entries stay in
    the report (the Omega-communicating baseline, grids that do not
    divide the shape) but are never chosen."""
    variant: str
    cost: M.Cost
    seconds: float
    grid: Optional[Tuple[int, int, int]] = None
    q_grid: Optional[Tuple[int, int, int]] = None
    executable: bool = True
    note: str = ""


@dataclasses.dataclass(frozen=True)
class Plan:
    """An executable dispatch decision plus everything needed to audit it."""
    task: str                       # "sketch" | "nystrom" | "stream"
    variant: str
    dims: Tuple[int, ...]           # sketch, stream: (n1, n2, r); nystrom: (n, r)
    n_procs: int
    dtype: str
    kind: str                       # Omega entry distribution
    grid: Optional[Tuple[int, int, int]]
    q_grid: Optional[Tuple[int, int, int]]
    predicted_words: float          # per-processor interconnect words
    predicted_flops: float
    predicted_hbm_words: float
    predicted_seconds: float
    lower_bound_words: float
    regime: int
    candidates: Tuple[Candidate, ...]
    machine: str
    executable: bool = True
    chunk_rows: Optional[int] = None
    corange: bool = False                      # stream plans only
    sketch_l: Optional[int] = None             # stream plans only
    measured_seconds: Optional[float] = None   # set by plan.autotune
    nnz: Optional[float] = None                # stored-sparse A's nonzeros
    # the Omega kind asked for: ``kind`` differs where a sparse variant
    # won and substituted CountSketch; the dense candidates draw this one
    requested_kind: Optional[str] = None
    notes: Tuple[str, ...] = ()                # the autotuner's, for explain

    @property
    def bound_gap_words(self) -> float:
        """Predicted words above the Theorem 2/3 floor."""
        return self.predicted_words - self.lower_bound_words

    @property
    def bound_ratio(self) -> float:
        if self.lower_bound_words == 0.0:
            return 1.0 if self.predicted_words == 0.0 else math.inf
        return self.predicted_words / self.lower_bound_words

    # -- execution ----------------------------------------------------------

    def execute(self, A, seed=0, device=None):
        """Make the call the chosen variant names, on ``device`` (``None``:
        the card; ``A`` is moved there).

        sketch : B = A·Omega — this rank's ``output_block`` for ``alg1``
                 (None past the grid), the whole B otherwise;
        nystrom: (B, C) — this rank's blocks in the layout of the entry
                 point the variant names (``nystrom_no_redist``,
                 ``nystrom_redist``, ``nystrom_two_grid(_fused)``), the
                 whole pair on one card;
        stream : the accumulator (``StreamingSketch`` or
                 ``ShardedStreamingSketch``) after A is fed in
                 ``chunk_rows`` slabs; call ``.nystrom()`` or
                 ``.reconstruct()`` on it to finalize.

        A plan on P > 1 ranks runs on the default process group, and every
        rank passes the same full A, as ``rand_matmul_auto`` takes it."""
        if not self.executable:
            raise ValueError(
                f"plan {self.variant} for dims={self.dims}, P={self.n_procs} "
                f"is analytic-only (no executable grid divides the shape); "
                f"pad the shape or change P")
        if self.n_procs > 1:
            import torch.distributed as dist
            if not (dist.is_available() and dist.is_initialized()):
                raise ValueError(
                    f"plan {self.variant} on P={self.n_procs} ranks needs "
                    f"the default process group "
                    f"(torch.distributed.init_process_group)")
        from repro_torch.core.rng import resolve_device
        from repro_torch.obs import ledger as obs_ledger
        from repro_torch.obs import trace as obs_trace
        device = resolve_device(device)
        A = torch.as_tensor(A).to(device)
        run = {"sketch": self._execute_sketch,
               "nystrom": self._execute_nystrom,
               "stream": self._execute_stream}.get(self.task)
        if run is None:
            raise ValueError(self.task)
        led = obs_ledger.get_ledger()
        t0 = time.perf_counter() if led is not None else 0.0
        with obs_trace.span("plan.execute", cat="plan", task=self.task,
                            variant=self.variant, dims=list(self.dims),
                            P=self.n_procs):
            out = run(A, seed, device)
        if led is not None:
            # analytic site: execute dispatches into the entry points,
            # whose own sites measure; the cache_key ties drift flags back
            # to plan.autotune
            from .autotune import cache_key
            led.record(f"plan.execute[{self.task}/{self.variant}]",
                       predicted_words=self.predicted_words,
                       lower_bound_words=self.lower_bound_words,
                       itemsize=_itemsize(self.dtype),
                       cache_key=cache_key(self, device=device),
                       wall_s=time.perf_counter() - t0,
                       detail=(self.dims, self.n_procs))
        return out

    def _execute_sketch(self, A, seed, device):
        r = self.dims[2]
        if self.variant == "alg1":
            from repro_torch.core.sketch import (input_block,
                                                 make_grid_groups,
                                                 rand_matmul)
            g = make_grid_groups(*self.grid)
            return rand_matmul(input_block(A, g), seed, r, g, kind=self.kind)
        if self.variant == "cuda_fused":
            from repro_torch.kernels.ops import sketch_matmul
            return sketch_matmul(A, seed=seed, r=r, kind=self.kind)
        if self.variant == "local_torch":
            from repro_torch.core.sketch import sketch_reference
            return sketch_reference(A, seed, r, kind=self.kind)
        if self.variant == "local_sparse":
            from repro_torch.core.sketch import sketch_sparse_apply
            return sketch_sparse_apply(A, seed, r, kind=self.kind)
        raise ValueError(self.variant)

    def _execute_nystrom(self, A, seed, device):
        from repro_torch.core import nystrom as nys
        from repro_torch.core.sketch import input_block, make_grid_groups
        r = self.dims[1]
        fn = {"alg2_no_redist": nys.nystrom_no_redist,
              "alg2_redist": nys.nystrom_redist}.get(self.variant)
        if fn is not None:
            g = make_grid_groups(*self.grid)
            return fn(input_block(A, g), seed, r, g, kind=self.kind)
        fn = {"alg2_bound_driven": nys.nystrom_two_grid,
              "alg2_bound_driven_fused": nys.nystrom_two_grid_fused
              }.get(self.variant)
        if fn is not None:
            return fn(input_block(A, make_grid_groups(*self.grid)), seed, r,
                      p=self.grid, q=self.q_grid, kind=self.kind)
        if self.variant == "cuda_fused":
            from repro_torch.kernels.ops import nystrom_fused
            return nystrom_fused(A, seed=seed, r=r, kind=self.kind)
        if self.variant == "local_torch":
            return nys.nystrom_reference(A, seed, r, kind=self.kind)
        raise ValueError(self.variant)

    def _execute_stream(self, A, seed, device):
        from repro_torch.stream.state import (SparseRows, StreamConfig,
                                              StreamingSketch)
        n1, n2, r = self.dims
        cfg = StreamConfig(n1=n1, n2=n2, r=r, seed=seed, kind=self.kind,
                           corange=self.corange, l=self.sketch_l)
        k = self.chunk_rows or n1
        if self.variant == "stream_sparse":
            st = StreamingSketch(cfg, device=device)
            for row0 in range(0, n1, k):
                st.update_rows_sparse(
                    row0, SparseRows.from_dense(A[row0:row0 + k]))
            return st
        if self.variant == "stream_local":
            st = StreamingSketch(cfg, device=device)
        elif self.variant == "stream_sharded":
            from repro_torch.core.sketch import make_grid_groups
            from repro_torch.stream.distributed import ShardedStreamingSketch
            st = ShardedStreamingSketch(cfg, make_grid_groups(*self.grid),
                                        device=device)
        else:
            raise ValueError(self.variant)
        for row0 in range(0, n1, k):
            st.update_rows(row0, A[row0:row0 + k])
        return st


# ---------------------------------------------------------------------------
# plan_sketch
# ---------------------------------------------------------------------------

def _alg1_executable(n1: int, n2: int, r: int,
                     grid: Tuple[int, int, int]) -> bool:
    """Whether ``core.sketch.rand_matmul`` can run ``grid`` on (n1, n2, r):
    A laid out P(p1, (p2, p3)), B laid out P((p1, p2), p3), so the
    reduce-scatter splits each n1/p1 row block p2 ways."""
    p1, p2, p3 = grid
    return (n1 % (p1 * p2) == 0 and n2 % (p2 * p3) == 0 and n2 % p2 == 0
            and r % p3 == 0 and p1 <= n1 and p2 <= n2 and p3 <= r)


def _best_executable_alg1_grid(n1: int, n2: int, r: int, P: int):
    """The paper's grid if it divides the shape, else the factorization of
    P that does with the fewest (words, latency hops); None if none does."""
    g: MatmulGrid = select_matmul_grid(n1, n2, r, P)
    if _alg1_executable(n1, n2, r, g.shape):
        return g.shape
    best = None
    for cand in factorizations_3d(P):
        if not _alg1_executable(n1, n2, r, cand):
            continue
        c = M.alg1_cost(n1, n2, r, cand)
        key = (c.words, c.messages)
        if best is None or key < best[0]:
            best = (key, cand)
    return best[1] if best else None


def _one_card(fused: M.Cost, plain: M.Cost, kind: str,
              machine: M.MachineModel, isz: int) -> list:
    """The two one-card candidates, the kernel's first: a tie goes to it."""
    dense = kind in DENSE_KINDS
    return [Candidate("cuda_fused", fused, fused.seconds(machine, isz),
                      executable=dense,
                      note="" if dense else
                      f"the kernels draw {', '.join(DENSE_KINDS)} only"),
            Candidate("local_torch", plain, plain.seconds(machine, isz))]


def plan_sketch(n1: int, n2: int, r: int, P: Optional[int] = None,
                dtype="float32", kind: str = "normal",
                machine: Optional[M.MachineModel] = None,
                nnz: Optional[int] = None) -> Plan:
    """Plan B = A·Omega for an (n1 x n2) A on P processors.

    ``nnz`` declares A stored-sparse with that many nonzeros and adds the
    sparse sketch family to the candidates (``local_sparse``: one
    scatter-add an entry, a COO payload): a sparse ``kind`` is kept, a
    dense one is paired with CountSketch (a different sketch family; the
    chosen plan's ``kind`` says what will run, and the candidate's note
    who lost and why).  Dense candidates stay in the race at their dense
    cost."""
    P = _world(P)
    machine = machine or M.probe_machine()
    dtype = _dtype_name(dtype)
    isz = _itemsize(dtype)
    lb = matmul_lower_bound(n1, n2, r, P)
    regime = matmul_regime(n1, n2, r, P)

    cands = []
    if P == 1:
        cands += _one_card(M.local_cost(n1, n2, r),
                           M.local_torch_cost(n1, n2, r), kind, machine, isz)
    else:
        grid = _best_executable_alg1_grid(n1, n2, r, P)
        if grid is not None:
            c = M.alg1_cost(n1, n2, r, grid)
            cands.append(Candidate("alg1", c, c.seconds(machine, isz),
                                   grid=grid))
            cc = M.alg1_communicating_cost(n1, n2, r, grid)
            cands.append(Candidate(
                "alg1_communicating", cc, cc.seconds(machine, isz),
                grid=grid, executable=False,
                note="Fig.-3 baseline: Omega over the wire, never chosen"))
        else:
            ideal = select_matmul_grid(n1, n2, r, P).shape
            c = M.alg1_cost(n1, n2, r, ideal)
            cands.append(Candidate(
                "alg1", c, c.seconds(machine, isz), grid=ideal,
                executable=False,
                note=f"no factorization of P={P} divides the shape"))

    if nnz is not None:
        skind = kind if kind in SPARSE_KINDS else "countsketch"
        grid = (1, 1, 1) if P == 1 else (_best_executable_alg1_grid(
            n1, n2, r, P) or select_matmul_grid(n1, n2, r, P).shape)
        cs = M.sparse_sketch_cost(n1, n2, r, nnz, grid, skind)
        cands.append(Candidate(
            "local_sparse" if P == 1 else "alg1_sparse",
            cs, cs.seconds(machine, isz),
            grid=None if P == 1 else grid, executable=(P == 1),
            note="" if P == 1 else "distributed sparse bodies are "
                                   "deferred, as in the reference"))
        cands = _note_sparse_losses(cands, kind, skind, nnz, n1 * n2)

    plan = _finish_plan("sketch", (n1, n2, r), P, dtype, kind, machine,
                        cands, lb, regime)
    if nnz is not None and plan.variant in ("local_sparse", "alg1_sparse"):
        plan = dataclasses.replace(plan, kind=skind)
    return dataclasses.replace(plan, nnz=nnz)


def _note_sparse_losses(cands, kind: str, skind: str, nnz: int,
                        dense_entries: int):
    """Notes on the sparse-vs-dense race: whoever loses is told why, in
    words a report reader can check against the cost model."""
    ex = [c for c in cands if c.executable]
    if not ex:
        return cands
    best = min(ex, key=lambda c: c.seconds)
    density = nnz / max(dense_entries, 1)
    out = []
    for c in cands:
        sparse = c.variant in ("local_sparse", "alg1_sparse",
                               "stream_sparse")
        if sparse and c.executable and c is not best:
            note = (f"dense wins at density {density:.3g} "
                    f"({best.seconds:.3g}s vs {c.seconds:.3g}s)")
            if c.note:
                note = f"{c.note}; {note}"
            c = dataclasses.replace(c, note=note)
        elif sparse and c is best and kind not in SPARSE_KINDS:
            note = (f"substitutes {skind} for requested {kind!r} "
                    f"(different sketch family) at density {density:.3g}")
            if c.note:
                note = f"{c.note}; {note}"
            c = dataclasses.replace(c, note=note)
        out.append(c)
    return out


# ---------------------------------------------------------------------------
# plan_nystrom
# ---------------------------------------------------------------------------

def plan_nystrom(n: int, r: int, P: Optional[int] = None,
                 dtype="float32", kind: str = "normal",
                 machine: Optional[M.MachineModel] = None,
                 variant: str = "auto") -> Plan:
    """Plan the Nyström pair (B, C) for a symmetric (n x n) A on P ranks.

    The redist / no_redist choice falls out of the cost model: redist's
    n·r/P all-to-all beats no_redist's (1-1/P)·r² reduce-scatter when P
    exceeds about n/r, the paper's Fig.-7 crossover.  The §5.3
    bound-driven two-grid pair (``nystrom_two_grid``) is a third
    candidate, and where one rank order serves both grids
    (``core.grid.two_grid_axis_split``) its fused form
    (``nystrom_two_grid_fused``, the Redistribute priced at what moves)
    a fourth.

    variant: ``"auto"`` lets the cost model choose; ``"no_redist"`` /
    ``"redist"`` / ``"bound_driven"`` / ``"bound_driven_fused"`` force
    that variant (the others stay in ``candidates``)."""
    requires = {"auto": None, "no_redist": "alg2_no_redist",
                "redist": "alg2_redist",
                "bound_driven": "alg2_bound_driven",
                "bound_driven_fused": "alg2_bound_driven_fused"}
    if variant not in requires:
        raise ValueError(f"unknown variant {variant!r}")
    require = requires[variant]
    P = _world(P)
    machine = machine or M.probe_machine()
    dtype = _dtype_name(dtype)
    isz = _itemsize(dtype)
    lb = nystrom_lower_bound(n, r, P)
    regime = nystrom_regime(n, r, P)

    cands = []
    if P == 1:
        if require is not None:
            raise ValueError(f"variant={variant!r} needs P > 1")
        cands += _one_card(M.nystrom_local_cost(n, r),
                           M.nystrom_local_torch_cost(n, r), kind, machine,
                           isz)
    else:
        executable_1d = (n % P == 0 and r % P == 0 and P <= n)
        note = "" if executable_1d else f"needs P | n and P | r (P={P})"
        p = (P, 1, 1)
        for vname, q in (("alg2_no_redist", (P, 1, 1)),
                         ("alg2_redist", (1, 1, P))):
            c = M.alg2_cost(n, r, p, q)
            cands.append(Candidate(vname, c, c.seconds(machine, isz),
                                   grid=p, q_grid=q,
                                   executable=executable_1d, note=note))
        # §5.3 approach 1: the bound-driven pair, snapped to the min-words
        # executable pair when the ideal grids do not divide (n, r); the
        # analytic row alone when no pair does
        ideal = select_nystrom_grids(n, r, P, variant="bound_driven")
        got = select_two_grid_executable(n, r, P)
        if got is not None:
            p_bd, q_bd, exact = got
            cb = M.alg2_cost(n, r, p_bd, q_bd)
            note = "" if exact else (
                f"snapped from ideal p={tuple(ideal.p)} q={tuple(ideal.q)} "
                f"(+{cb.words - M.alg2_cost(n, r, ideal.p, ideal.q).words:g}"
                f" words over the unrunnable ideal)")
            cands.append(Candidate(
                "alg2_bound_driven", cb, cb.seconds(machine, isz),
                grid=p_bd, q_grid=q_bd, executable=True, note=note))
            if two_grid_axis_split(p_bd, q_bd) is not None:
                fnote = (note + "; " if note else "") + \
                    "in-program Redistribute (shared mesh)"
                cf = M.alg2_fused_cost(n, r, p_bd, q_bd)
                cands.append(Candidate(
                    "alg2_bound_driven_fused", cf, cf.seconds(machine, isz),
                    grid=p_bd, q_grid=q_bd, executable=True, note=fnote))
        else:
            cb = M.alg2_cost(n, r, ideal.p, ideal.q)
            cands.append(Candidate(
                "alg2_bound_driven", cb, cb.seconds(machine, isz),
                grid=tuple(ideal.p), q_grid=tuple(ideal.q), executable=False,
                note=f"no (p, q) factorization pair of P={P} divides "
                     f"(n={n}, r={r})"))

    return _finish_plan("nystrom", (n, r), P, dtype, kind, machine,
                        cands, lb, regime, require=require)


# ---------------------------------------------------------------------------
# plan_stream
# ---------------------------------------------------------------------------

def plan_stream(n1: int, n2: int, r: int, P: Optional[int] = None,
                chunk_rows: Optional[int] = None, l: Optional[int] = None,
                corange: bool = False, dtype="float32",
                kind: str = "normal",
                machine: Optional[M.MachineModel] = None,
                nnz: Optional[int] = None) -> Plan:
    """Plan a full streaming pass over A in row slabs of ``chunk_rows``
    (default n1/8): the local accumulator against the sharded one, each
    priced at one slab's ``stream_update_cost`` times the slabs.

    ``nnz`` declares the whole pass stored-sparse with that many nonzeros
    and adds the COO ingest candidate (``stream_sparse``:
    ``update_rows_sparse``), with :func:`plan_sketch`'s kind substitution
    and notes."""
    P = _world(P)
    machine = machine or M.probe_machine()
    dtype = _dtype_name(dtype)
    isz = _itemsize(dtype)
    chunk_rows = chunk_rows or max(1, n1 // 8)
    n_upd = math.ceil(n1 / chunk_rows)
    l_eff = l if l is not None else min(2 * r + 1, n1)
    lb = matmul_lower_bound(n1, n2, r, P)
    regime = matmul_regime(n1, n2, r, P)

    def scaled(c: M.Cost) -> M.Cost:
        return M.Cost(words=c.words * n_upd, messages=c.messages * n_upd,
                      flops=c.flops * n_upd, hbm_words=c.hbm_words * n_upd)

    cands = []
    c_loc = scaled(M.stream_update_cost(chunk_rows, n2, r, l_eff,
                                        (1, 1, 1), corange))
    cands.append(Candidate("stream_local", c_loc, c_loc.seconds(machine, isz),
                           executable=(P == 1),
                           note="" if P == 1 else "single-device only"))
    if P > 1:
        grid = _best_executable_alg1_grid(n1, n2, r, P)
        if grid is not None:
            c = scaled(M.stream_update_cost(chunk_rows, n2, r, l_eff,
                                            grid, corange))
            cands.append(Candidate("stream_sharded", c,
                                   c.seconds(machine, isz), grid=grid))

    if nnz is not None:
        skind = kind if kind in SPARSE_KINDS else "countsketch"
        nnz_u = nnz / n_upd                      # a slab's payload
        cs = scaled(M.sparse_stream_update_cost(chunk_rows, n2, r, l_eff,
                                                nnz_u, (1, 1, 1), corange,
                                                skind))
        cands.append(Candidate(
            "stream_sparse", cs, cs.seconds(machine, isz),
            executable=(P == 1),
            note="" if P == 1 else "single-device only (distributed "
                                   "sparse bodies are deferred, as in the "
                                   "reference)"))
        cands = _note_sparse_losses(cands, kind, skind, nnz, n1 * n2)

    plan = _finish_plan("stream", (n1, n2, r), P, dtype, kind, machine,
                        cands, lb, regime)
    if nnz is not None and plan.variant == "stream_sparse":
        plan = dataclasses.replace(plan, kind=skind)
    return dataclasses.replace(plan, chunk_rows=chunk_rows, corange=corange,
                               sketch_l=l, nnz=nnz)


# ---------------------------------------------------------------------------
# plan_train_compression — per-leaf raw-vs-sketched gradient exchange
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafDecision:
    """One parameter leaf's priced exchange choice.  ``m``/``n`` are the
    leaf folded to a matrix (leading dims merged, as the exchange folds
    it); ``r_eff = min(rank, m, n)``.  Leaves with ndim < 2 always go raw.
    ``raw_seconds`` / ``comp_seconds`` are both costs' seconds on the
    plan's machine, whichever objective decided."""
    name: str
    shape: Tuple[int, ...]
    m: int
    n: int
    r_eff: int
    compress: bool
    raw_cost: M.Cost
    comp_cost: M.Cost
    raw_seconds: float
    comp_seconds: float
    note: str = ""

    @property
    def words(self) -> float:
        """Predicted exchange words for the decision taken."""
        return self.comp_cost.words if self.compress else self.raw_cost.words


@dataclasses.dataclass(frozen=True)
class TrainCompressionPlan:
    """Per-leaf decisions, in :func:`param_leaves` order, for
    ``train.step.make_dp_compressed_step``.

    ``exchange_words`` (compressed leaves ``r·(m+n)``, raw ones ``m·n``)
    is also the plan's ``lower_bound_words``: Omega is regenerated (zero
    words), but the factors must move, so a schedule that meets the
    prediction is at the floor."""
    rank: int
    n_procs: int
    dtype: str
    kind: str
    machine: str
    objective: str
    decisions: Tuple[LeafDecision, ...]
    tree: object          # the params' structure (a nested dict)

    def decision_tree(self):
        """Nested dict of per-leaf bools, the params' structure."""
        return unflatten_like(self.tree, [d.compress for d in self.decisions])

    @property
    def exchange_words(self) -> float:
        return sum(d.words for d in self.decisions)

    @property
    def raw_words(self) -> float:
        return sum(d.raw_cost.words for d in self.decisions)

    @property
    def lower_bound_words(self) -> float:
        return self.exchange_words

    @property
    def savings(self) -> float:
        ex = self.exchange_words
        return self.raw_words / ex if ex > 0 else 1.0

    @property
    def n_compressed(self) -> int:
        return sum(1 for d in self.decisions if d.compress)


def plan_train_compression(params_shapes, rank: int, P: Optional[int] = None,
                           *, dtype="float32", kind: str = "normal",
                           machine: Optional[M.MachineModel] = None,
                           objective: str = "words"
                           ) -> TrainCompressionPlan:
    """Decide, per leaf of ``params_shapes`` (any nested dict of objects
    with a ``shape``: tensors, meta tensors), raw all-reduce vs sketched
    exchange at ``P`` workers (default: the process group's world size, 1
    without one), priced by ``grad_allreduce_cost`` and
    ``grad_compress_cost`` on ``machine`` (default ``probe_machine()``):

      * ``"words"`` (default) — compress iff ``r_eff·(m+n) < m·n`` words,
        the paper's objective, and what training runs on;
      * ``"seconds"`` — compress iff the predicted seconds drop (the
        added rank-r work can outweigh the network saving).

    Beware at one worker: both exchanges move 0 words there, so the words
    objective compresses nothing at ``P=1``; a one-card run that should
    exercise the sketched exchange passes the plan priced for the worker
    count it stands for (``P=8``)."""
    if objective not in ("words", "seconds"):
        raise ValueError(f"unknown objective {objective!r} "
                         f"(want words|seconds)")
    P = _world(P)
    machine = machine or M.probe_machine()
    dtype = _dtype_name(dtype)
    isz = _itemsize(dtype)
    decisions = []
    for name, leaf in param_leaves(params_shapes):
        shape = tuple(int(s) for s in leaf.shape)
        if len(shape) < 2:
            m = 1 if not shape else shape[0]
            raw = M.grad_allreduce_cost(m, 1, P)
            s = raw.seconds(machine, isz)
            decisions.append(LeafDecision(name, shape, m, 1, 0, False, raw,
                                          raw, s, s, "not a matrix"))
            continue
        m, n = math.prod(shape[:-1]), shape[-1]
        r_eff = min(rank, m, n)
        raw = M.grad_allreduce_cost(m, n, P)
        comp = M.grad_compress_cost(m, n, r_eff, P)
        raw_s, comp_s = raw.seconds(machine, isz), comp.seconds(machine, isz)
        if objective == "words":
            compress = comp.words < raw.words
        else:
            compress = comp_s < raw_s
        note = ""
        if not compress:
            note = ("network saving < added rank-r compute"
                    if objective == "seconds" else
                    "one worker: both move 0 words" if P <= 1 else
                    "below crossover r >= m*n/(m+n)")
        elif objective == "words" and comp_s > raw_s:
            note = "words win; seconds would not on this machine"
        decisions.append(LeafDecision(name, shape, m, n, r_eff, compress,
                                      raw, comp, raw_s, comp_s, note))
    return TrainCompressionPlan(rank=rank, n_procs=P, dtype=dtype, kind=kind,
                                machine=machine.name, objective=objective,
                                decisions=tuple(decisions),
                                tree=params_shapes)


# ---------------------------------------------------------------------------
# shared tail
# ---------------------------------------------------------------------------

def _finish_plan(task: str, dims: Tuple[int, ...], P: int, dtype: str,
                 kind: str, machine: M.MachineModel,
                 cands: Sequence[Candidate], lb: float, regime: int,
                 require: Optional[str] = None) -> Plan:
    """The best executable candidate (of ``require``'s variant when
    given): a stable sort on (not executable, seconds, device-memory
    words, words), so a tie keeps the listed order."""
    cands = tuple(sorted(
        cands, key=lambda c: (not c.executable, c.seconds,
                              c.cost.hbm_words, c.cost.words)))
    eligible = [c for c in cands
                if require is None or c.variant == require]
    chosen = next((c for c in eligible if c.executable), None)
    if chosen is None:
        # analytic-only plan; execute() raises
        chosen = eligible[0] if eligible else cands[0]
    return Plan(
        task=task, variant=chosen.variant, dims=tuple(dims), n_procs=P,
        dtype=dtype, kind=kind, grid=chosen.grid, q_grid=chosen.q_grid,
        predicted_words=chosen.cost.words,
        predicted_flops=chosen.cost.flops,
        predicted_hbm_words=chosen.cost.hbm_words,
        predicted_seconds=chosen.seconds,
        lower_bound_words=lb, regime=regime, candidates=cands,
        machine=machine.name, executable=chosen.executable,
        requested_kind=kind)
