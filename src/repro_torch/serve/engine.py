"""The sketch-serving entry points (the sketch half of the reference's
``serve/engine.py``): a :class:`SketchService` on one card or over a grid
of ranks, and the bounded async :class:`IngestQueue` in front of it."""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.sketch import make_grid_groups
from repro_torch.parallel.grad_compress import world_size
from repro_torch.plan.model import choose_bucket_edges, probe_machine
from repro_torch.plan.planner import Plan, plan_sketch
from repro_torch.stream.ingest import IngestQueue
from repro_torch.stream.service import SketchService


def make_sketch_service(grid=None, plan=None,
                        shape: Optional[Tuple[int, int, int]] = None,
                        max_resident: Optional[int] = None,
                        spill_dir: Optional[str] = None,
                        device=None) -> SketchService:
    """The streaming-sketch serving entry point: many streams on one card
    (``device=None``; pass ``device="cpu"`` for the plain path).

    grid:
      * ``None`` — local mode;
      * ``(p1, p2, p3)`` — a distributed service: every stream sharded
        over that grid of the default process group's ranks
        (``make_grid_groups``, which every rank must call in the same
        order), each update running Alg. 1 (``SketchService(mesh=...)``);
      * ``"auto"`` — the grid ``plan_sketch`` chooses for the dominant
        stream shape, ``shape=(n1, n2, r)``, at the world's size.
    plan: a :class:`repro_torch.plan.Plan` (``plan_stream`` or
    ``plan_sketch``; wins over ``grid``): its grid places the service, and
    a single-device plan gives local mode.  ``max_resident`` is the
    admission budget: colder non-pinned streams move to host memory, or
    to ``spill_dir`` on disk when it is given, and are restored bitwise
    on next touch.
    """
    kw = dict(max_resident=max_resident, spill_dir=spill_dir, device=device)
    if plan is None and grid == "auto":
        if shape is None:
            raise ValueError('grid="auto" needs the dominant stream shape: '
                             'shape=(n1, n2, r)')
        plan = plan_sketch(*shape, P=world_size())
    if plan is not None:
        if not isinstance(plan, Plan):
            raise TypeError(f"plan must be a repro_torch.plan.Plan "
                            f"(plan_stream or plan_sketch); got {plan!r}")
        if not plan.executable:
            raise ValueError(
                f"plan {plan.variant!r} for dims={plan.dims}, "
                f"P={plan.n_procs} is analytic-only (no executable grid "
                f"divides the shape) — no service grid can host it")
        if plan.grid is None:        # a single-device plan: local mode
            return SketchService(**kw)
        grid = plan.grid
    mesh = None if grid is None else make_grid_groups(*grid)
    return SketchService(mesh=mesh, **kw)


def make_ingest_queue(service: SketchService, depth: int = 256,
                      window: int = 64, bucket_edges="auto",
                      expected_ks=None, **cfg) -> IngestQueue:
    """Front a service with the bounded async queue.

    ``bucket_edges="auto"`` prices bucket tops with
    :func:`repro_torch.plan.choose_bucket_edges` from ``expected_ks`` (the
    expected lane heights, e.g. a recent traffic sample), on the machine
    entry of the service's device (``probe_machine``) and the shape of
    its first stream; with no sample, no stream open, or a grid service
    (whose lanes are full-shape updates, one at a time), the queue snaps
    lanes to pow2 buckets, as with ``bucket_edges=None``.  Any remaining
    kwargs go to :class:`IngestQueue`."""
    if bucket_edges == "auto":
        bucket_edges = None
        first = next(iter(service._streams.values()), None)
        if expected_ks and first is not None and service.mesh is None:
            c = first.cfg
            bucket_edges = choose_bucket_edges(
                list(expected_ks), c.n2, c.r, c.sketch_l, corange=c.corange,
                machine=probe_machine(service.device))
    return IngestQueue(service, depth=depth, window=window,
                       bucket_edges=bucket_edges, **cfg)
