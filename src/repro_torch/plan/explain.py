"""Human-readable word table of a gradient-exchange plan."""
from __future__ import annotations

from typing import List

from .planner import TrainCompressionPlan


def _fmt(x: float) -> str:
    return f"{x:.4g}"


def explain_train_compression(plan: TrainCompressionPlan) -> str:
    """One row per parameter leaf: raw all-reduce words (m·n), sketched
    words (r·(m+n)) and the decision, then the step totals."""
    lines: List[str] = [
        f"TrainCompressionPlan rank={plan.rank} P={plan.n_procs} "
        f"objective={plan.objective}",
        "  Omega is regenerated per (leaf, step), so only the factors P "
        "(m·r) and Q (r·n) move — compress iff r < m·n/(m+n)"]
    head = ("leaf", "shape", "r", "raw words", "sketch words", "decision")
    rows = [(d.name, "x".join(map(str, d.shape)) or "()",
             str(d.r_eff) if d.r_eff else "-", _fmt(d.raw_cost.words),
             _fmt(d.comp_cost.words),
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
