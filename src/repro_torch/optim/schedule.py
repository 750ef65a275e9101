"""LR schedules (pure functions of the step counter)."""
from __future__ import annotations

import math


def warmup_cosine(step: int, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> float:
    """Linear warm-up to ``peak_lr``, then cosine decay to
    ``final_frac·peak_lr`` at ``total_steps`` (the reference's schedule)."""
    step = float(step)
    if step < warmup_steps:
        return peak_lr * (step + 1) / max(warmup_steps, 1)
    t = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                0.0), 1.0)
    return peak_lr * (final_frac + (1 - final_frac)
                      * 0.5 * (1 + math.cos(math.pi * t)))
