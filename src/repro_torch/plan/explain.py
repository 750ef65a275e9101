"""Readable plan reports: the chosen regime, crossovers, bound gaps (the
reference's ``plan/explain.py``).

``explain(plan)`` renders one plan; ``regime_sweep`` tabulates the chosen
variant across a range of P (the planner's view of the paper's Fig. 7
crossover); ``explain_train_compression`` is the word and seconds table
of a gradient-exchange plan.  ``bound_report`` reuses
:class:`repro_torch.core.lower_bounds.BoundReport` for the "what would a
non-random GEMM pay" comparison.
"""
from __future__ import annotations

import math
from typing import Iterable, List

from repro_torch.core.grid import two_grid_axis_split
from repro_torch.core.lower_bounds import (BoundReport, report_matmul,
                                           report_nystrom)

from . import model as M
from .planner import Plan, TrainCompressionPlan


def sketch_zero_comm_limit(n1: int) -> int:
    """Largest P with a zero-communication sketch plan (Thm. 2 regime 1)."""
    return n1


def nystrom_crossover_P(n: int, r: int) -> int:
    """Smallest P where the redist all-to-all (nr/P words) beats the
    no_redist reduce-scatter ((1-1/P)·r² words): P > n/r + 1."""
    return int(math.floor(n / max(r, 1))) + 2


def _fmt(x: float) -> str:
    if x == 0:
        return "0"
    if abs(x) >= 1e4 or 0 < abs(x) < 1e-3:
        return f"{x:.3e}"
    return f"{x:.4g}"


def bound_report(plan: Plan) -> BoundReport:
    if plan.task == "nystrom":
        n, r = plan.dims
        return report_nystrom(n, r, plan.n_procs)
    n1, n2, r = plan.dims
    return report_matmul(n1, n2, r, plan.n_procs)


#: What each one-card body does with Omega, as ``explain`` prints it.
_BODIES = {
    "cuda_fused": "kernel body: Omega drawn once a call into a "
                  "device-memory scratch by the sketch_fwd / sketch_t "
                  "kernels, released when the call returns "
                  "(kernels/csrc/omega_slab.cuh)",
    "local_torch": "materialized body: Omega written to device memory by "
                   "gen_omega (the plain Philox on the CPU), then "
                   "torch.matmul",
}


def explain(plan: Plan) -> str:
    """Multi-line report for one plan."""
    rep = bound_report(plan)
    thm = "Theorem 3" if plan.task == "nystrom" else "Theorem 2"
    lines: List[str] = []
    lines.append(f"Plan[{plan.task}] dims={plan.dims} P={plan.n_procs} "
                 f"dtype={plan.dtype} kind={plan.kind} "
                 f"machine={plan.machine}")
    lines.append(f"  {thm} regime {plan.regime}: lower bound "
                 f"{_fmt(plan.lower_bound_words)} words/proc "
                 f"(non-random GEMM would need {_fmt(rep.gemm_words)}; "
                 f"savings {_fmt(rep.savings_vs_gemm)}x)")
    grid = f" grid={plan.grid}" if plan.grid else ""
    qg = f" q={plan.q_grid}" if plan.q_grid else ""
    chunk = f" chunk_rows={plan.chunk_rows}" if plan.chunk_rows else ""
    lines.append(f"  chosen: {plan.variant}{grid}{qg}{chunk}")
    if plan.variant in _BODIES:
        lines.append(f"          {_BODIES[plan.variant]}")
    if plan.variant in ("local_sparse", "alg1_sparse", "stream_sparse"):
        lines.append(f"          sparse family ({plan.kind}): O(nnz) "
                     "scatter ingest; payload shipped as COO "
                     "(indices+values) = 2*nnz words, not dense tiles "
                     "(plan.model.sparse_payload_words)")
    lines.append(f"          predicted {_fmt(plan.predicted_words)} words/proc"
                 f" (gap over bound {_fmt(plan.bound_gap_words)}, "
                 f"ratio {_fmt(plan.bound_ratio)})")
    lines.append(f"          {_fmt(plan.predicted_flops)} FLOPs/proc, "
                 f"{_fmt(plan.predicted_hbm_words)} device-memory "
                 f"words/proc, est {_fmt(plan.predicted_seconds)} s")
    if plan.measured_seconds is not None:
        lines.append(f"          measured {_fmt(plan.measured_seconds)} s "
                     f"(autotuned)")
    for note in plan.notes:
        lines.append(f"  autotune: {note}")
    if (plan.task == "nystrom" and plan.grid and plan.q_grid
            and tuple(plan.grid) != tuple(plan.q_grid)):
        n, r = plan.dims
        rw = M.redistribute_words(n, r, plan.grid, plan.q_grid)
        how = ("general two-grid (§5.3 approach 1): stage 1 on p, stage 2 "
               "on q" if plan.variant in ("alg2_bound_driven",
                                          "alg2_bound_driven_fused")
               else "B re-laid out between stages")
        if plan.variant == "alg2_bound_driven_fused":
            fw = M.fused_redistribute_words(n, r, plan.grid, plan.q_grid)
            lines.append(f"          {how}; Redistribute of B p->q (§5.2) "
                         f"as one all-to-all: {_fmt(fw)} words/proc (the "
                         f"n·r/P bound: {_fmt(rw)})")
        else:
            line = (f"          {how}; Redistribute of B p->q priced at "
                    f"the n·r/P bound, {_fmt(rw)} words/proc (§5.2)")
            if (plan.variant == "alg2_bound_driven"
                    and two_grid_axis_split(plan.grid, plan.q_grid)
                    is not None):
                fw = M.fused_redistribute_words(n, r, plan.grid,
                                                plan.q_grid)
                line += f"; the all-to-all moves {_fmt(fw)}"
            lines.append(line)
    if plan.task in ("sketch", "stream"):
        n1 = plan.dims[0]
        lines.append(f"  zero-communication regime up to P <= n1 = {n1}"
                     f" (regenerate-don't-communicate, paper §4.3 case 1)")
    else:
        n, r = plan.dims
        lines.append(f"  redist/no_redist crossover at P ~ n/r = "
                     f"{nystrom_crossover_P(n, r)} (paper Fig. 7)")
    if not plan.executable:
        lines.append("  NOTE: analytic-only plan — no executable grid "
                     "divides this shape")
    lines.append("  candidates (best first; * = chosen):")
    for c in plan.candidates:
        mark = "*" if (c.variant == plan.variant and c.executable
                       and c.grid == plan.grid) else " "
        where = f" grid={c.grid}" if c.grid else ""
        whereq = f" q={c.q_grid}" if c.q_grid else ""
        tail = f"  [{c.note}]" if c.note else ""
        exe = "" if c.executable else "  (analytic-only)"
        lines.append(f"   {mark} {c.variant:<20}{where}{whereq}"
                     f"  {_fmt(c.cost.words):>10} words"
                     f"  {_fmt(c.cost.hbm_words):>10} hbm"
                     f"  {_fmt(c.seconds):>10} s{exe}{tail}")
    return "\n".join(lines)


def explain_train_compression(plan: TrainCompressionPlan) -> str:
    """One row per parameter leaf: raw all-reduce words (m·n), sketched
    words (r·(m+n)), both costs' seconds on the plan's machine and the
    decision, then the step totals."""
    lines: List[str] = [
        f"TrainCompressionPlan rank={plan.rank} P={plan.n_procs} "
        f"dtype={plan.dtype} machine={plan.machine} "
        f"objective={plan.objective}",
        "  Omega is regenerated per (leaf, step), so only the factors P "
        "(m·r) and Q (r·n) move — compress iff r < m·n/(m+n)"]
    head = ("leaf", "shape", "r", "raw words", "sketch words", "raw s",
            "sketch s", "decision")
    rows = [(d.name, "x".join(map(str, d.shape)) or "()",
             str(d.r_eff) if d.r_eff else "-", _fmt(d.raw_cost.words),
             _fmt(d.comp_cost.words), _fmt(d.raw_seconds),
             _fmt(d.comp_seconds),
             ("compress" if d.compress else "raw")
             + (f"  [{d.note}]" if d.note else ""))
            for d in plan.decisions]
    widths = [max(len(head[i]), *(len(r[i]) for r in rows))
              for i in range(len(head))]

    def fmt_row(r):
        return "  " + " | ".join(v.ljust(w) for v, w in zip(r, widths))
    lines.append(fmt_row(head))
    lines.append("  " + "-+-".join("-" * w for w in widths))
    lines.extend(fmt_row(r) for r in rows)
    lines.append(f"  totals: {_fmt(plan.exchange_words)} words/step/worker "
                 f"vs {_fmt(plan.raw_words)} raw ({_fmt(plan.savings)}x "
                 f"saving; {plan.n_compressed}/{len(plan.decisions)} leaves "
                 f"compressed)")
    return "\n".join(lines)


def regime_sweep(plan_fn, dims: tuple, Ps: Iterable[int], **kw) -> str:
    """Table of the chosen variant, grid and words against P (the Fig.-7
    view):

        regime_sweep(plan_sketch, (4096, 4096, 256), [1, 8, 64, 512])
    """
    rows = []
    for P in Ps:
        p = plan_fn(*dims, P=P, **kw)
        rows.append((P, p.regime, p.variant,
                     str(p.grid or "-"), _fmt(p.predicted_words),
                     _fmt(p.lower_bound_words)))
    head = ("P", "regime", "variant", "grid", "pred words", "bound words")
    widths = [max(len(head[i]), *(len(str(r[i])) for r in rows))
              for i in range(len(head))]

    def fmt_row(r):
        return " | ".join(str(v).ljust(w) for v, w in zip(r, widths))
    sep = "-+-".join("-" * w for w in widths)
    return "\n".join([fmt_row(head), sep] + [fmt_row(r) for r in rows])
