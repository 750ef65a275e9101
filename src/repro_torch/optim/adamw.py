"""AdamW with global-norm clipping: bf16 params, f32 moments (the
reference's ``optim/adamw.py``).

The reference is functional and returns new trees; the port updates the
params and moments IN PLACE under ``torch.no_grad``, because a second copy
of gemma2-2b's 21 GB of f32 moments does not fit beside the first.  The
arithmetic is the reference's, leaf by leaf, in f32, rounded once into the
param's dtype.  As in the reference, decay applies to every leaf with
``ndim >= 2``: the stacked per-layer norm scales (L, d) are decayed too.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.api import param_leaves, unflatten_like


@dataclass
class AdamWState:
    m: dict            # f32 first moments, the params' tree
    v: dict            # f32 second moments
    count: int = 0


def init(params) -> AdamWState:
    def zeros(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    def tree():
        return unflatten_like(params, [zeros(t)
                                       for _, t in param_leaves(params)])
    return AdamWState(tree(), tree(), 0)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (a 0-d tensor)."""
    sq = [torch.linalg.vector_norm(t, dtype=torch.float32) ** 2
          for _, t in param_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf IN PLACE by ``min(1, max_norm / max(norm, 1e-9))``;
    returns ``(grads, norm)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for _, g in param_leaves(grads):
        g.mul_(scale)
    return grads, norm


# Elements a pass of ``update``: the f32 temporaries of a leaf are taken
# a slice at a time, so an embedding's do not add several of its copies to
# the peak.  The arithmetic is elementwise, so the slices change no bit.
CHUNK = 1 << 26


def _slices(t: torch.Tensor, inplace: bool):
    flat = t.view(-1) if inplace else t.reshape(-1)
    return flat.split(CHUNK)


@torch.no_grad()
def update(grads, state: AdamWState, params, lr: float, *,
           b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1):
    """One AdamW step, params and moments updated in place; returns
    ``(params, state)``.  Decay is decoupled and skipped for 1-D leaves."""
    state.count += 1
    c1 = 1.0 - b1 ** state.count
    c2 = 1.0 - b2 ** state.count
    for (_, p), (_, g), (_, m), (_, v) in zip(
            param_leaves(params), param_leaves(grads),
            param_leaves(state.m), param_leaves(state.v)):
        decay = p.dim() >= 2 and weight_decay
        for ps, gs, ms, vs in zip(_slices(p, True), _slices(g, False),
                                  _slices(m, True), _slices(v, True)):
            gf = gs.float()
            ms.mul_(b1).add_((1 - b1) * gf)
            vs.mul_(b2).add_((1 - b2) * gf * gf)
            step = (ms / c1) / (torch.sqrt(vs / c2) + eps)
            del gf
            pf = ps.float()
            if decay:
                step.add_(pf * weight_decay)
            ps.copy_(pf.sub_(step.mul_(lr)))
    return params, state
