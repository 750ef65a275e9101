"""Feed-forward layers of the reference's ``models/ffn.py``: the dense
gated FFN (SwiGLU / GeGLU), Whisper's biased GELU MLP, and the top-k MoE
with capacity-based dispatch in both of the reference's forms
(``scatter`` and the GShard ``einsum``).

``jax.nn.gelu`` defaults to the tanh approximation, while
``torch.nn.functional.gelu`` defaults to the exact erf form: the port
asks for ``approximate="tanh"``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import dense_init, matmul, normal_stack

ACTIVATIONS = {"silu": F.silu,
               "gelu": lambda x: F.gelu(x, approximate="tanh")}


class FFNParams(NamedTuple):
    w_gate: torch.Tensor   # (d, f)
    w_up: torch.Tensor     # (d, f)
    w_down: torch.Tensor   # (f, d)


def ffn_init(gen, d: int, f: int, dtype, device,
             layers: int = 0) -> FFNParams:
    kw = dict(dtype=dtype, device=device, layers=layers)
    return FFNParams(
        w_gate=dense_init(gen, d, f, **kw),
        w_up=dense_init(gen, d, f, **kw),
        w_down=dense_init(gen, f, d, scale=1.0 / math.sqrt(f), **kw),
    )


def ffn(params: FFNParams, x: torch.Tensor,
        activation: str = "silu") -> torch.Tensor:
    g = matmul(x, params.w_gate)
    u = matmul(x, params.w_up)
    return matmul(ACTIVATIONS[activation](g) * u, params.w_down)


# plain 2-layer MLP with biases (whisper)
class MLPParams(NamedTuple):
    w1: torch.Tensor   # (d, f)
    b1: torch.Tensor   # (f,)
    w2: torch.Tensor   # (f, d)
    b2: torch.Tensor   # (d,)


def mlp_init(gen, d: int, f: int, dtype, device,
             layers: int = 0) -> MLPParams:
    """``w1`` scaled by ``1/sqrt(d)``, ``w2`` by ``1/sqrt(f)``, zero
    biases; with ``layers`` every leaf gets a leading stack axis."""
    kw = dict(dtype=dtype, device=device, layers=layers)
    lead = (layers,) if layers else ()
    return MLPParams(
        w1=dense_init(gen, d, f, **kw),
        b1=torch.zeros(lead + (f,), dtype=dtype, device=device),
        w2=dense_init(gen, f, d, scale=1.0 / math.sqrt(f), **kw),
        b2=torch.zeros(lead + (d,), dtype=dtype, device=device))


def mlp(params: MLPParams, x: torch.Tensor) -> torch.Tensor:
    """``gelu(x w1 + b1) w2 + b2``, the tanh GELU, the biases added in
    x's dtype."""
    h = ACTIVATIONS["gelu"](matmul(x, params.w1) + params.b1.to(x.dtype))
    return matmul(h, params.w2) + params.b2.to(x.dtype)


# ---------------------------------------------------------------------------
# top-k MoE with capacity-based dispatch
# ---------------------------------------------------------------------------

class MoEParams(NamedTuple):
    router: torch.Tensor   # (d, E), float32 in every model dtype
    w_gate: torch.Tensor   # (E, d, f)
    w_up: torch.Tensor     # (E, d, f)
    w_down: torch.Tensor   # (E, f, d)


def moe_init(gen, d: int, f: int, n_experts: int, dtype, device,
             layers: int = 0) -> MoEParams:
    """The reference's scales: the router ``1/sqrt(d)`` in f32, gate and
    up ``1/sqrt(d)``, down ``1/sqrt(f)``; with ``layers`` every leaf gets
    a leading stack axis of that many."""
    lead = (layers,) if layers else ()
    E = n_experts
    return MoEParams(
        router=dense_init(gen, d, E, torch.float32, device, layers=layers),
        w_gate=normal_stack(gen, lead + (E, d, f), 1.0 / math.sqrt(d),
                            dtype, device),
        w_up=normal_stack(gen, lead + (E, d, f), 1.0 / math.sqrt(d),
                          dtype, device),
        w_down=normal_stack(gen, lead + (E, f, d), 1.0 / math.sqrt(f),
                            dtype, device),
    )


class MoERoutes(NamedTuple):
    probs: torch.Tensor      # (N, E) f32 router softmax
    gate_vals: torch.Tensor  # (N, k) f32, renormalised over the k
    gate_idx: torch.Tensor   # (N, k) int64 experts, best first
    onehot: torch.Tensor     # (N, k, E) int64 one-hot of gate_idx
    pos: torch.Tensor        # (N, k) the assignment's slot in its expert
    keep: torch.Tensor       # (N, k) bool, pos < cap
    cap: int                 # slots an expert


def moe_routes(params: MoEParams, xt: torch.Tensor, *, top_k: int,
               capacity_factor: float = 1.25) -> MoERoutes:
    """Token-choice top-k routing of ``xt`` (N, d) with per-expert capacity
    (the reference's ``moe`` up to the dispatch).

    The logits are ``x @ router`` in f32 (TF32 stays off: the default of
    ``torch.backends.cuda.matmul``), the softmax in f32, the top k sorted
    best first, the gates renormalised by ``max(sum, 1e-9)``.  A tie
    between two probabilities is broken toward the lower expert by
    ``jax.lax.top_k``; ``torch.topk`` promises no order on ties, so exact
    ties may route otherwise.  An assignment's slot is the count of
    earlier assignments to its expert in the token-major, then k, order;
    those at or past ``cap = max(1, int(capacity_factor·k·N/E))`` drop.
    Both dispatch forms route so: the reference's scatter form counts
    slots within groups (``G``), the data-parallel shards, each of
    ``N / G`` tokens and with the capacity of that many; the port has no
    mesh, so G = 1 and both forms take N, as the einsum form does."""
    N = xt.shape[0]
    E = params.router.shape[-1]
    logits = xt.float() @ params.router                       # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)    # (N, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    cap = max(1, int(capacity_factor * top_k * N / E))
    onehot = F.one_hot(gate_idx, E)                           # (N, k, E)
    flat = onehot.reshape(N * top_k, E)
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(N, top_k, E)
    pos = (pos * onehot).sum(-1)                              # (N, k)
    return MoERoutes(probs, gate_vals, gate_idx, onehot, pos, pos < cap,
                     cap)


def _scatter_dispatch(params: MoEParams, xt, r: MoERoutes) -> torch.Tensor:
    """Scatter the kept assignments into (E, cap, d) expert buffers, run
    the experts, gather back: O(N·k·d) data movement."""
    N, d = xt.shape
    E, k = params.router.shape[-1], r.gate_idx.shape[1]
    idx = r.gate_idx.reshape(-1)                              # (N·k,)
    keep = r.keep.reshape(-1)
    pos = r.pos.reshape(-1)
    # slot cap takes the dropped assignments and is sliced off, so they
    # reach no expert and get no gradient
    buf = torch.zeros(E, r.cap + 1, d, dtype=xt.dtype, device=xt.device)
    buf = buf.index_put((idx, torch.where(keep, pos, r.cap)),
                        xt.repeat_interleave(k, dim=0))
    ye = _experts(params, buf[:, :r.cap])
    w = (r.gate_vals.reshape(-1) * keep).to(xt.dtype)
    picked = ye[idx, torch.where(keep, pos, 0)]               # (N·k, d)
    # token n's k assignments are rows n·k .. n·k + k - 1: the reference's
    # scatter-add over tok_id is a sum over k, in f32
    return (picked * w[:, None]).float().reshape(N, k, d).sum(1).to(
        xt.dtype)


def einsum_dispatch_matrix(r: MoERoutes, dtype):
    """The einsum form's (N, E, cap) one-hot dispatch tensor (1 where token
    n's kept assignment to expert e sits at slot c) and the (N, k, cap)
    one-hot of the slots."""
    # F.one_hot refuses a class past its range, where jax.nn.one_hot gives
    # a zero row (a dropped position): slicing off one extra class does
    pos_oh = F.one_hot(torch.clamp(r.pos, max=r.cap), r.cap + 1)[..., :r.cap]
    disp = torch.einsum("nke,nkc->nec",
                        r.onehot.to(dtype) * r.keep[..., None].to(dtype),
                        pos_oh.to(dtype))
    return disp, pos_oh


def _einsum_dispatch(params: MoEParams, xt, r: MoERoutes) -> torch.Tensor:
    """GShard-style one-hot dispatch and combine einsums: O(N·E·cap·d)
    FLOPs."""
    dt = xt.dtype
    disp, pos_oh = einsum_dispatch_matrix(r, dt)
    xe = torch.einsum("nd,nec->ecd", xt, disp)                # (E, cap, d)
    ye = _experts(params, xe)
    comb = torch.einsum("nke,nkc,nk->nec", r.onehot.float(), pos_oh.float(),
                        r.gate_vals * r.keep.float()).to(dt)
    return torch.einsum("ecd,nec->nd", ye, comb)


def _experts(params: MoEParams, xe: torch.Tensor) -> torch.Tensor:
    """The experts on their (E, cap, d) buffers: three batched GEMMs, each
    summed in f32 and rounded to the activation's dtype, with silu
    whatever the model's activation (as the reference)."""
    g = matmul(xe, params.w_gate)
    u = matmul(xe, params.w_up)
    return matmul(F.silu(g) * u, params.w_down)


def moe(params: MoEParams, x: torch.Tensor, *, top_k: int,
        capacity_factor: float = 1.25, return_aux: bool = False,
        dispatch: str = "scatter"):
    """Top-k MoE of ``x`` (B, S, d) -> (B, S, d), with the Switch-style
    load-balancing loss ``E · sum(mean probs · share of tokens routed to
    each expert)`` (before the capacity drop) when ``return_aux``.

    ``dispatch``: ``scatter`` (the reference's default: buffers written
    and read by index) or ``einsum`` (one-hot dispatch and combine).  Both
    give the same routes and drops (:func:`moe_routes`); the combine
    multiplies each expert output by its gate in x's dtype and sums over
    k in f32 (scatter), or in one einsum (einsum form)."""
    run = {"scatter": _scatter_dispatch, "einsum": _einsum_dispatch}.get(
        dispatch)
    if run is None:
        raise ValueError(f"unknown MoE dispatch {dispatch!r}: scatter | "
                         f"einsum")
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    r = moe_routes(params, xt, top_k=top_k, capacity_factor=capacity_factor)
    y = run(params, xt, r).reshape(B, S, d)
    if not return_aux:
        return y
    E = params.router.shape[-1]
    me = r.probs.mean(0)                                      # (E,)
    ce = (r.onehot.sum(1) > 0).float().mean(0)                # (E,)
    return y, E * torch.sum(me * ce)
