"""The honesty report: predicted vs measured vs the paper's floor, per site
(the reference's ``obs/report.py``).

``honesty_report`` renders one table row per ledger site — predicted
interconnect words (``plan/model.py``), measured words this rank received
(``parallel.collectives.COMM`` and ``parallel.grad_compress.COMM`` around
the dispatch, ``obs.ledger``), the Theorem-2/3 floor, accumulated wall
time, and the two audit ratios (``bound_fraction``, ``drift``).  The
columns and their formatting are the reference's.

``drift_flags`` + ``revalidate_autotune`` close the measurement loop with
the planner: a site whose measured words diverged from its prediction past
the threshold names the autotune cache entry that decision came from, and
revalidation pops it — the next ``plan.autotune`` call at that key
re-measures instead of trusting the stale decision.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

from .ledger import CommLedger, LedgerSite


def report_rows(ledger: CommLedger) -> List[dict]:
    """One plain dict per site, report-ready."""
    rows = []
    for s in sorted(ledger.sites(), key=lambda s: s.name):
        rows.append({
            "site": s.name,
            "calls": s.calls,
            "predicted_words": s.predicted_words,
            "measured_bytes_per_call": s.measured_bytes_per_call,
            "measured_words_per_call": s.measured_words_per_call,
            "lower_bound_words": s.lower_bound_words,
            "bound_fraction": s.bound_fraction,
            "drift": s.drift,
            "wall_s": s.wall_s,
            "cache_key": s.cache_key,
        })
    return rows


def _fmt(v, unit: str = "") -> str:
    if v is None:
        return "-"
    if isinstance(v, float) and math.isinf(v):
        return "inf"
    if isinstance(v, float):
        return f"{v:.4g}{unit}"
    return f"{v}{unit}"


def honesty_report(ledger: CommLedger,
                   machine_words_per_s: Optional[float] = None) -> str:
    """Fixed-width table of every site's predicted/measured/floor audit.

    ``machine_words_per_s`` (e.g. ``MachineModel.byte_bw / itemsize``)
    adds a roofline-fraction column: the share of each site's wall time
    the measured traffic would need at peak interconnect bandwidth.
    """
    cols = ["site", "calls", "pred_words", "meas_words", "thm_floor",
            "bound_frac", "drift", "wall_s"]
    if machine_words_per_s:
        cols.append("roofline_frac")
    table = [cols]
    for r in report_rows(ledger):
        row = [r["site"], str(r["calls"]),
               _fmt(r["predicted_words"]),
               _fmt(r["measured_words_per_call"]),
               _fmt(r["lower_bound_words"]),
               _fmt(r["bound_fraction"]),
               _fmt(r["drift"]),
               _fmt(r["wall_s"])]
        if machine_words_per_s:
            mw = r["measured_words_per_call"]
            if mw is None or r["wall_s"] <= 0 or r["calls"] == 0:
                row.append("-")
            else:
                need = mw * r["calls"] / machine_words_per_s
                row.append(_fmt(need / r["wall_s"]))
        table.append(row)
    widths = [max(len(row[i]) for row in table) for i in range(len(cols))]
    lines = []
    for j, row in enumerate(table):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


# -- drift hook: feed plan/autotune revalidation -----------------------------

def drift_flags(ledger: CommLedger,
                threshold: float = 0.25) -> List[Tuple[LedgerSite, float]]:
    """Sites whose measured words diverged from the planner prediction by
    more than ``threshold`` (relative) — ``(site, drift)`` pairs, worst
    first.  Analytic-only sites (no measured bytes) never flag."""
    if threshold < 0:
        raise ValueError("threshold must be >= 0")
    out = []
    for s in ledger.sites():
        d = s.drift
        if d is not None and abs(d) > threshold:
            out.append((s, d))
    out.sort(key=lambda t: -abs(t[1]))
    return out


def revalidate_autotune(ledger: CommLedger, cache,
                        threshold: float = 0.25) -> List[str]:
    """Pop every autotune cache entry named by a drift-flagged site.

    ``cache`` is a :class:`repro_torch.plan.autotune.AutotuneCache`
    (anything with ``pop(key)``).  Returns the popped keys; the next
    ``autotune`` call at each key misses the cache and re-measures."""
    popped = []
    for site, _ in drift_flags(ledger, threshold):
        if site.cache_key and site.cache_key not in popped:
            if cache.pop(site.cache_key) is not None:
                popped.append(site.cache_key)
    return popped
