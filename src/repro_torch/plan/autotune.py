"""Machine-model calibration from measured records (the part of the
reference's ``plan/autotune.py`` that the port runs).

A record is one measured call beside its analytic counts: ``words``,
``messages``, ``flops``, ``hbm_words``, ``itemsize`` and the measured
``seconds`` (the card's records also carry ``device_kind`` and the power
limit).  :func:`calibrate_machine_model` least-squares fits the network
terms of a :class:`~repro_torch.plan.model.MachineModel` to them;
``save_sweep`` / ``load_sweep`` keep them as JSON.  ``chip_smoke.py``
writes the card's records (phases 3-4 and 12-16) to
``build/repro_torch/cost_sweep.json``; ``h100_sweep.json`` beside this
module is the committed set that the H100 entry's ``alpha`` and
``byte_bw`` are the fit of.

The measured autotuner and its cache (``autotune``, ``sweep_records``),
which refine the planner's analytic ranking, are ROADMAP item 7c.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import List, Optional, Sequence

from . import model as M

CACHE_VERSION = 2

#: The card records behind the H100 entry's network terms.
H100_SWEEP = pathlib.Path(__file__).with_name("h100_sweep.json")


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
