"""Sketched gradient compression for data-parallel training (the
reference's ``parallel/grad_compress.py``).

Per DP worker, per compressed weight matrix G (m x n), every step t:

    M      = G + E                              (f32, E the error feedback)
    P      = mean( M @ Omega(key(leaf, t)) )    m·r words; Omega regenerated
    P_hat  = orthonormalize(P)                  thin QR, local
    Qᵀ_loc = P_hatᵀ @ M                         (r, n)
    Qᵀ     = mean(Qᵀ_loc)                       r·n words
    G_hat  = P_hat @ Qᵀ                         the rank-r mean estimate
    E'     = M - P_hat @ Qᵀ_loc                 error feedback, local

so a matrix moves r·(m+n) words instead of m·n: Omega costs none, since
every worker regenerates it from the (leaf, step) Philox key.  The sketch
runs through ``sketch_block`` (K2 on the card) and the three dense
products through ``gemm_block`` (K5).

In place, to fit the full-size model on one card: M is formed in the
error buffer itself, E' is written back into it by K5 with M as the
aliased accumulator, and G_hat is written into the gradient tensor.  The
error buffer is the worker's own: it has no world axis.

``allreduce_mean`` is ``torch.distributed.all_reduce(SUM)`` divided by the
world size when a process group is up (gloo has no AVG) and the identity
at world 1.  It counts the words it moves in ``COMM`` (the stand-in for the
reference's comm-ledger audit of the exchange).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.kernels.local import gemm_block, sketch_block
from repro_torch.models.api import param_leaves, unflatten_like

# Words moved by allreduce_mean since the last reset_comm(), and its calls.
COMM = {"words": 0, "calls": 0}


def reset_comm() -> None:
    COMM["words"] = 0
    COMM["calls"] = 0


def world_size(group=None) -> int:
    """The process group's size, 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def worker_rank(group=None) -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group)
    return 0


def allreduce_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``t`` over the workers, IN PLACE; the identity at world
    1 (which moves no word)."""
    world = world_size(group)
    if world == 1:
        return t
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    t.div_(world)
    COMM["words"] += t.numel()
    COMM["calls"] += 1
    return t


def leaf_seed(idx: int, step: int):
    """The Philox key pair of (leaf, step): the leaf's position in
    :func:`param_leaves` order, Knuth-hashed, in key0; the step in key1.
    Every worker computes the same pair, so Omega costs no word."""
    k0 = (0x5EEDED ^ (idx * 2654435761)) & 0xFFFFFFFF
    return (k0, int(step) & 0xFFFFFFFF)


def _compressible(leaf, min_dim: int) -> bool:
    """The legacy size heuristic: compress a matrix leaf whose folded dims
    are both at least ``min_dim``.  The planner's priced ``decisions`` map
    supersedes it (``plan.plan_train_compression``)."""
    if leaf.dim() < 2:
        return False
    m, n = math.prod(leaf.shape[:-1]), leaf.shape[-1]
    return m >= min_dim and n >= min_dim


def _flags(grads, decisions, min_dim=None):
    """Per-leaf compress flags: the planner's map when given (its True
    entries clamped to matrix leaves), else the ``min_dim`` heuristic."""
    leaves = param_leaves(grads)
    if decisions is not None:
        flags = [bool(f) for _, f in param_leaves(decisions)]
        if len(flags) != len(leaves):
            raise ValueError(
                f"decisions has {len(flags)} leaves, grads have "
                f"{len(leaves)} — pass plan_train_compression(...)"
                f".decision_tree() for these params")
        return [f and g.dim() >= 2 for f, (_, g) in zip(flags, leaves)]
    if min_dim is None:
        raise ValueError("need either decisions= (planner map) or "
                         "min_dim= (legacy heuristic)")
    return [_compressible(g, min_dim) for _, g in leaves]


def _orthonormalize(P: torch.Tensor) -> torch.Tensor:
    """Thin QR's Q, in f32."""
    return torch.linalg.qr(P.float()).Q


@torch.no_grad()
def compress_and_allreduce(grads, error_fb, *, step: int, rank: int,
                           decisions=None, min_dim=None,
                           kind: str = "normal", group=None):
    """Replace the mean of ``grads`` over the workers by the sketched
    exchange; returns ``(grads, error_fb)``, both updated IN PLACE.

    ``decisions``: per-leaf bools, the params' structure
    (``plan_train_compression(...).decision_tree()``); without it the
    legacy ``min_dim`` heuristic decides.  Raw leaves take an
    exact mean and keep their error buffer.  ``step`` enters Omega through
    the key pair, so a restored run regenerates the original draws.
    """
    flags = _flags(grads, decisions, min_dim)
    fb = param_leaves(error_fb)
    for idx, ((_, g), (_, e), compress) in enumerate(
            zip(param_leaves(grads), fb, flags)):
        if not compress:
            allreduce_mean(g, group)
            continue
        m, n = math.prod(g.shape[:-1]), g.shape[-1]
        r = min(rank, m, n)
        M = e.add_(g).view(m, n)                  # M = g + e, in e
        P = allreduce_mean(sketch_block(M, leaf_seed(idx, step), r,
                                        kind=kind), group)
        P_hat = _orthonormalize(P)
        Qt_loc = gemm_block(P_hat.T, M)           # (r, n)
        Qt = Qt_loc if world_size(group) == 1 else allreduce_mean(
            Qt_loc.clone(), group)
        gemm_block(P_hat, Qt, out_dtype=g.dtype, out=g.view(m, n))
        gemm_block(P_hat, Qt_loc, acc=M, alpha=-1.0)   # e' = M - P̂·Qᵀ_loc
    return grads, error_fb


def comm_words_exact(shapes) -> int:
    """Words a plain mean of these grads would move (per step, worker)."""
    return sum(math.prod(t.shape) for _, t in param_leaves(shapes))


def comm_words_compressed(shapes, rank: int, decisions=None, *,
                          min_dim=None) -> int:
    """Words the sketched exchange moves: r·(m+n) per compressed leaf,
    full size for raw leaves (``decisions``, else the ``min_dim``
    heuristic, picks them).  Equals the plan's ``exchange_words`` at more
    than one worker, and what ``allreduce_mean`` counts there."""
    total = 0
    for (_, t), compress in zip(param_leaves(shapes),
                                _flags(shapes, decisions, min_dim)):
        if compress:
            m, n = math.prod(t.shape[:-1]), int(t.shape[-1])
            total += min(rank, m, n) * (m + n)
        else:
            total += math.prod(t.shape)
    return total


def init_error_fb(params, decisions=None, *, min_dim=None):
    """Zero f32 error buffers of the leaf's shape for compressed leaves
    (``decisions``, else the ``min_dim`` heuristic), a 0-d zero elsewhere;
    one worker's, with no world axis."""
    leaves = [torch.zeros(t.shape if f else (), dtype=torch.float32,
                          device=t.device)
              for (_, t), f in zip(param_leaves(params),
                                   _flags(params, decisions, min_dim))]
    return unflatten_like(params, leaves)


def reshard_error_fb(fb, world_from: int, world_to: int):
    """Re-lay error buffers stacked over a leading world axis (none at world
    1: a checkpoint of every worker's buffer) onto another DP width,
    keeping each leaf's worker MEAN, the only statistic the exchange reads
    (both means are linear in E).  Same width: unchanged.  Shrink by an
    integer factor: adjacent groups averaged; grow by one: replicated;
    otherwise every new worker gets the global mean."""
    if world_from == world_to:
        return fb

    def one(x: torch.Tensor) -> torch.Tensor:
        x = x[None] if world_from == 1 else x
        if world_from % world_to == 0:
            g = world_from // world_to
            x = x.reshape((world_to, g) + tuple(x.shape[1:])).mean(dim=1)
        elif world_to % world_from == 0:
            x = x.repeat_interleave(world_to // world_from, dim=0)
        else:
            x = x.mean(dim=0, keepdim=True).expand(
                (world_to,) + tuple(x.shape[1:])).clone()
        return x[0] if world_to == 1 else x
    return unflatten_like(fb, [one(t) for _, t in param_leaves(fb)])
