"""Per-leaf raw-vs-sketched decision of the DP gradient exchange (the
reference's ``plan_train_compression`` with ``objective="words"``), and
the snap of Alg. 1's §4.3 grid to one that divides the shape.

Beware at one worker: both exchanges move 0 words there, and a leaf
compresses only when its words strictly drop, so ``P=1`` compresses
nothing.  A one-card run that should exercise the sketched exchange passes
the plan priced for the worker count it stands for (``P=8``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.core.grid import (MatmulGrid, factorizations_3d,
                                   select_matmul_grid)
from repro_torch.models.api import param_leaves, unflatten_like
from . import model as M


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


@dataclasses.dataclass(frozen=True)
class LeafDecision:
    """One parameter leaf's priced exchange choice.  ``m``/``n`` are the
    leaf folded to a matrix (leading dims merged, as the exchange folds
    it); ``r_eff = min(rank, m, n)``.  Leaves with ndim < 2 always go raw."""
    name: str
    shape: Tuple[int, ...]
    m: int
    n: int
    r_eff: int
    compress: bool
    raw_cost: M.Cost
    comp_cost: M.Cost
    note: str = ""

    @property
    def words(self) -> float:
        """Predicted exchange words for the decision taken."""
        return self.comp_cost.words if self.compress else self.raw_cost.words


@dataclasses.dataclass(frozen=True)
class TrainCompressionPlan:
    """Per-leaf decisions, in :func:`param_leaves` order, for
    ``train.step.make_dp_compressed_step``."""
    rank: int
    n_procs: int
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
    def savings(self) -> float:
        ex = self.exchange_words
        return self.raw_words / ex if ex > 0 else 1.0

    @property
    def n_compressed(self) -> int:
        return sum(1 for d in self.decisions if d.compress)


def plan_train_compression(params_shapes, rank: int, P: Optional[int] = None,
                           *, objective: str = "words"
                           ) -> TrainCompressionPlan:
    """Decide, per leaf of ``params_shapes`` (any nested dict of objects
    with a ``shape``: tensors, meta tensors), raw all-reduce vs sketched
    exchange: compress iff ``r_eff·(m+n) < m·n`` words at ``P`` workers
    (default: the process group's world size, 1 without one)."""
    if objective == "seconds":
        raise NotImplementedError(
            "objective='seconds' needs the planner's seconds objective, "
            "not ported yet (ROADMAP.md Queue 1, item 7b); use "
            "objective='words'")
    if objective != "words":
        raise ValueError(f"unknown objective {objective!r} (want words)")
    if P is None:
        from repro_torch.parallel.grad_compress import world_size
        P = world_size()
    decisions = []
    for name, leaf in param_leaves(params_shapes):
        shape = tuple(int(s) for s in leaf.shape)
        if len(shape) < 2:
            m = 1 if not shape else shape[0]
            raw = M.grad_allreduce_cost(m, 1, P)
            decisions.append(LeafDecision(name, shape, m, 1, 0, False, raw,
                                          raw, "not a matrix"))
            continue
        m, n = math.prod(shape[:-1]), shape[-1]
        r_eff = min(rank, m, n)
        raw = M.grad_allreduce_cost(m, n, P)
        comp = M.grad_compress_cost(m, n, r_eff, P)
        compress = comp.words < raw.words
        note = ("" if compress else "one worker: both move 0 words"
                if P <= 1 else "below crossover r >= m*n/(m+n)")
        decisions.append(LeafDecision(name, shape, m, n, r_eff, compress,
                                      raw, comp, note))
    return TrainCompressionPlan(rank=rank, n_procs=P, objective=objective,
                                decisions=tuple(decisions),
                                tree=params_shapes)
