"""Train step factories: loss -> grads -> (exchange) -> clip -> AdamW.

  * ``make_train_step`` — one worker, with gradient accumulation.
  * ``make_dp_compressed_step`` — data parallel over the process group
    (world 1 without one), the gradient mean replaced by the sketched
    exchange (``parallel/grad_compress.py``): Omega regenerated from the
    (leaf, step) seed, only the r·(m+n) factor words move.  Which leaves
    compress is the planner's decision (``plan.plan_train_compression``).

Both run eagerly (no compilation) and update the state IN PLACE.  A step
whose loss is not finite changes nothing and reports the loss, so the
loop's NaN skip keeps the old state as the reference's does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models.api import ModelAPI, param_leaves, unflatten_like
from repro_torch.obs import ledger as obs_ledger
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.parallel.grad_compress import (
    allreduce_mean, compress_and_allreduce, init_error_fb, worker_rank,
    world_size)
from .state import TrainState


def init_state(api: ModelAPI, cfg: ModelConfig, run: RunConfig, seed: int,
               device=None, decisions=None) -> TrainState:
    """Fresh state (``device=None``: the card).  With
    ``run.grad_compress_rank`` set, zero error buffers ride along for the
    leaves ``decisions`` compresses (the planner's map,
    ``plan_train_compression(...).decision_tree()``); None falls back to
    the legacy ``run.grad_compress_min_dim`` heuristic, as the reference
    does.  The buffers are this worker's own: no world axis."""
    params = api.init(seed, cfg, device)
    for _, t in param_leaves(params):
        t.requires_grad_(True)
    st = TrainState(params=params, opt=adamw.init(params), step=0)
    if run.grad_compress_rank:
        st.error_fb = init_error_fb(params, decisions,
                                    min_dim=run.grad_compress_min_dim)
    return st


def _value_and_grad(api, cfg, run, params, batch):
    leaves = [t for _, t in param_leaves(params)]
    loss = api.loss(params, cfg, batch, remat=run.remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), unflatten_like(params, list(grads))


def _apply(state: TrainState, grads, loss, run: RunConfig):
    """Clip, schedule and update in place; the step counter advances."""
    grads, gnorm = adamw.clip_by_global_norm(grads, run.grad_clip)
    lr = warmup_cosine(state.step, peak_lr=run.learning_rate,
                       warmup_steps=run.warmup_steps, total_steps=run.steps)
    adamw.update(grads, state.opt, state.params, lr,
                 weight_decay=run.weight_decay)
    state.step += 1
    return state, {"loss": loss, "grad_norm": float(gnorm), "lr": lr}


def make_train_step(api: ModelAPI, cfg: ModelConfig, run: RunConfig,
                    accum_steps: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)`` for one
    worker; with ``accum_steps`` the batch is split along its first axis
    and the gradients of the pieces are averaged in f32."""

    def train_step(state: TrainState, batch):
        if accum_steps == 1:
            loss, grads = _value_and_grad(api, cfg, run, state.params, batch)
        else:
            acc, tot = None, 0.0
            for i in range(accum_steps):
                mb = {k: v.chunk(accum_steps)[i] for k, v in batch.items()}
                l, g = _value_and_grad(api, cfg, run, state.params, mb)
                gl = [t.float() for _, t in param_leaves(g)]
                acc = gl if acc is None else [a.add_(b)
                                              for a, b in zip(acc, gl)]
                tot = tot + l.float()
            scale = 1.0 / accum_steps
            grads = unflatten_like(state.params,
                                   [a.mul_(scale) for a in acc])
            loss = tot * scale
        loss = float(loss)
        if not math.isfinite(loss):
            return state, {"loss": loss}
        return _apply(state, grads, loss, run)

    return train_step


def make_dp_compressed_step(api: ModelAPI, cfg: ModelConfig, run: RunConfig,
                            plan=None, group=None):
    """Data-parallel training with the sketched gradient exchange.

    Each worker takes its contiguous share of the global batch, computes
    its gradients, means the loss, and replaces the gradient mean by
    ``compress_and_allreduce``; then clip, schedule and AdamW, in that
    order.  ``plan``: a ``TrainCompressionPlan``, priced lazily at the
    process group's world size when None (at world 1 that compresses
    nothing: pass a plan priced for the worker count the run stands for).
    The plan in use is ``step.plan``.  On the card, ``step.exchange`` holds
    the CUDA events recorded around the last exchange.  ``step.group`` and
    ``step.data_parallel`` tell ``train_loop`` to checkpoint in the DP
    form.  The global batch is split by the group's size, so a run
    resumed onto fewer workers (``launch.elastic``) keeps it; there is no
    gradient accumulation, as in the reference's.

    With a ledger installed (``obs.ledger``) each step is observed at the
    ``train.dp_compressed_step`` site against the plan's exchange words
    plus the loss scalar's mean, ``exchange_words + 1``, which is also the
    floor: Omega is free (Theorem 2, regime 1), the factors and the loss
    must move, so a drift of 0 says the step moved exactly the words the
    planner priced.
    """
    from repro_torch.plan import plan_train_compression

    def step(state: TrainState, batch):
        if step.plan is None:
            step.plan = plan_train_compression(
                state.params, run.grad_compress_rank, P=world_size(group))
        if obs_ledger.get_ledger() is None:
            return _step(state, batch)
        words = step.plan.exchange_words + 1.0
        leaves = tuple(t for _, t in param_leaves(state.params))
        with obs_ledger.observing("train.dp_compressed_step",
                                  leaves + tuple(batch.values()),
                                  predicted_words=words,
                                  lower_bound_words=words, itemsize=4):
            return _step(state, batch)

    def _step(state: TrainState, batch):
        world, me = world_size(group), worker_rank(group)
        if world > 1:
            batch = {k: v.chunk(world)[me] for k, v in batch.items()}
        loss, grads = _value_and_grad(api, cfg, run, state.params, batch)
        loss = float(allreduce_mean(loss.float(), group))
        if not math.isfinite(loss):
            return state, {"loss": loss}
        on_card = param_leaves(state.params)[0][1].is_cuda
        if on_card:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        compress_and_allreduce(grads, state.error_fb, step=state.step,
                               rank=run.grad_compress_rank,
                               decisions=step.plan.decision_tree(),
                               group=group)
        if on_card:
            ev[1].record()
            step.exchange = tuple(ev)
        return _apply(state, grads, loss, run)

    step.plan = plan
    step.exchange = None
    step.group = group
    step.data_parallel = True
    return step
