"""repro_torch.roofline — the three-term roofline of the port's calls on
the card (the reference's ``repro.roofline``).

  counts.py   — :func:`counting`: a block's FLOPs, device bytes,
                collective bytes and kernel launches, counted as it runs
                (the role of the reference's ``hlo.py`` / ``hlo_cost.py``)
  analysis.py — :class:`RooflineTerms`, :func:`analyze_counts` /
                :func:`analyze_call` / :func:`analyze_cost`,
                :func:`format_table`, :func:`save_json`, and the card's
                rates (:data:`H100`, :func:`h100_rates`)

The reference's ``collective_bytes_of`` and ``op_histogram`` parse HLO
text and are not ported: their work is :class:`WorkCounts`'s
``collective_bytes`` / ``collective_by_kind`` / ``collective_counts`` and
its ``launches``.  No TPU constant is exported.
"""
from .counts import WorkCounts, counting, sum_counts  # noqa: F401
from .analysis import (  # noqa: F401
    H100, Rates, RooflineTerms, analyze_call, analyze_cost, analyze_counts,
    format_table, h100_rates, save_json,
)

__all__ = ["RooflineTerms", "WorkCounts", "counting", "sum_counts",
           "analyze_counts", "analyze_call", "analyze_cost", "format_table",
           "save_json", "H100", "Rates", "h100_rates"]
