"""Fault-tolerant training loop (the reference's ``train/loop.py``):

  * periodic atomic checkpoints (state + the data stream's position; the
    stream is step-indexed, so a restore resumes it exactly);
  * crash recovery: an exception falls back to the last checkpoint and
    resumes, within a budget of 10 restarts.  The step functions update
    the state in place, so a failure inside a step leaves it half updated:
    with no checkpoint to restore it the loop re-raises.  A refused kernel
    launch (``KernelLaunchError``) is a fault, not a node failure, and is
    re-raised at once;
  * data parallel: with a step of ``make_dp_compressed_step`` at more
    than one worker, every rank of its group runs this loop; checkpoints
    take the DP form (``checkpoint/ckpt.py``: each rank writes its own
    error buffers, rank 0 the replicated params and moments) and a restore
    gives each rank its own buffers back.  The crash path restores there
    only when EVERY rank fails at the same step, as an injected fault or
    a refused step on all of them does: a fault on one rank alone leaves
    the others inside the step's collectives, which would part ways;
  * a straggler monitor: EWMA step time, outliers beyond k sigma flagged;
  * a NaN guard: a step whose loss is not finite is skipped (the step
    functions leave the state untouched then) and the next batch is tried.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.kernels.sketch_matmul import KernelLaunchError
from repro_torch.models.api import param_leaves
from repro_torch.parallel.grad_compress import world_size
from .state import TrainState

MAX_RESTARTS = 10


class StragglerMonitor:
    """EWMA mean/var of step time; flags outliers beyond k sigma."""

    def __init__(self, alpha: float = 0.9, k: float = 3.0):
        self.alpha, self.k = alpha, k
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.flagged: List[Dict] = []

    def observe(self, step: int, dt: float) -> bool:
        if self.mean is None:
            self.mean = dt
            return False
        sigma = max(self.var ** 0.5, 1e-6)
        slow = dt > self.mean + self.k * sigma and dt > 1.5 * self.mean
        if slow:
            self.flagged.append({"step": step, "dt": dt, "mean": self.mean})
        d = dt - self.mean
        self.mean = self.alpha * self.mean + (1 - self.alpha) * dt
        self.var = self.alpha * self.var + (1 - self.alpha) * d * d
        return slow


@dataclasses.dataclass
class LoopResult:
    state: TrainState
    losses: List[float]
    restarts: int
    stragglers: List[Dict]
    checkpoints: List[int]
    step_seconds: List[float]


def train_loop(train_step: Callable, state: TrainState, data_cfg: DataConfig,
               run: RunConfig, *, device=None,
               failure_injector: Optional[Callable[[int], None]] = None,
               on_straggler: Optional[Callable[[int], None]] = None,
               on_step: Optional[Callable[[int, Dict], None]] = None
               ) -> LoopResult:
    """Run steps up to ``run.steps`` with checkpoint/restart fault
    tolerance.  Batches come from the port's pipeline on ``device``.

    ``failure_injector(step)`` may raise to simulate a node failure; the
    loop restores the last checkpoint (into the live state, in place) and
    continues.  ``on_step(step, metrics)`` sees every applied step.  Step
    times (host clock, up to a device synchronize after the step, so each
    step's time holds its own optimizer kernels) go to ``step_seconds``.
    """
    monitor = StragglerMonitor(run.straggler_ewma, run.straggler_sigma)
    losses: List[float] = []
    times: List[float] = []
    ckpts: List[int] = []
    restarts = 0
    start = int(state.step)
    pipe = Pipeline(data_cfg, start_step=start, device=device)
    step_i = start
    on_card = param_leaves(state.params)[0][1].is_cuda
    group = getattr(train_step, "group", None)
    world = (world_size(group) if getattr(train_step, "data_parallel", False)
             else 1)
    while step_i < run.steps:
        in_step = False
        try:
            batch = next(pipe)
            if failure_injector is not None:
                failure_injector(step_i)
            t0 = time.perf_counter()
            in_step = True
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            if on_card:
                torch.cuda.synchronize()
            in_step = False
            dt = time.perf_counter() - t0
            if monitor.observe(step_i, dt) and on_straggler is not None:
                on_straggler(step_i)
            step_i += 1
            if not math.isfinite(loss):
                continue                # the step left the state untouched
            losses.append(loss)
            times.append(dt)
            if on_step is not None:
                on_step(step_i - 1, metrics)
            if run.checkpoint_every and step_i % run.checkpoint_every == 0:
                ckpt.save(run.checkpoint_dir, step_i, state,
                          extra={"data": pipe.state()},
                          keep=run.keep_checkpoints, world=world,
                          group=group)
                ckpts.append(step_i)
        except (KeyboardInterrupt, KernelLaunchError):
            raise
        except Exception:  # noqa: BLE001 — the node-failure recovery path
            restarts += 1
            if restarts > MAX_RESTARTS:
                raise
            last = ckpt.latest_step(run.checkpoint_dir)
            if last is None:
                if in_step:
                    raise               # a half-updated state: no way back
                # no checkpoint yet: replay the stream from the start
                step_i = start
                pipe = Pipeline(data_cfg, start_step=start, device=device)
                continue
            state, step_i, extra = ckpt.restore(run.checkpoint_dir, state,
                                                world=world, group=group)
            pipe = Pipeline.from_state(
                data_cfg, extra.get("data", {"step": step_i,
                                             "seed": data_cfg.seed}),
                device=device)
    return LoopResult(state, losses, restarts, monitor.flagged, ckpts, times)
