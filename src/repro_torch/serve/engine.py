"""The sketch-serving entry points (the sketch half of the reference's
``serve/engine.py``): a :class:`SketchService` on one card or over a grid
of ranks, and the bounded async :class:`IngestQueue` in front of it."""
from __future__ import annotations

from typing import Optional

from repro_torch.core.sketch import make_grid_groups
from repro_torch.plan.model import choose_bucket_edges, probe_machine
from repro_torch.stream.ingest import IngestQueue
from repro_torch.stream.service import SketchService


def make_sketch_service(grid=None, plan=None,
                        max_resident: Optional[int] = None,
                        spill_dir: Optional[str] = None,
                        device=None) -> SketchService:
    """The streaming-sketch serving entry point: many streams on one card
    (``device=None``; pass ``device="cpu"`` for the plain path).

    ``grid=(p1, p2, p3)`` places a distributed service: every stream
    sharded over that grid of the default process group's ranks
    (``make_grid_groups``, which every rank must call in the same order),
    each update running Alg. 1 (``SketchService(mesh=...)``).
    ``grid="auto"`` and ``plan`` need the planner and raise
    ``NotImplementedError``, as does ``spill_dir``.  ``max_resident`` is
    the admission budget: colder non-pinned streams move to host memory
    and are restored bitwise on next touch.
    """
    if plan is not None or grid == "auto":
        raise NotImplementedError(
            "grid='auto' / plan= need plan_stream, which is not ported to "
            "repro_torch yet (ROADMAP Queue 1 item 7b); pass a (p1, p2, p3) "
            "grid")
    mesh = None if grid is None else make_grid_groups(*grid)
    return SketchService(mesh=mesh, max_resident=max_resident,
                         spill_dir=spill_dir, device=device)


def make_ingest_queue(service: SketchService, depth: int = 256,
                      window: int = 64, bucket_edges="auto",
                      expected_ks=None, **cfg) -> IngestQueue:
    """Front a local-mode service with the bounded async queue.

    ``bucket_edges="auto"`` prices bucket tops with
    :func:`repro_torch.plan.choose_bucket_edges` from ``expected_ks`` (the
    expected lane heights, e.g. a recent traffic sample), on the machine
    entry of the service's device (``probe_machine``) and the shape of
    its first stream; with no sample, or no stream open, the queue snaps
    lanes to pow2 buckets, as with ``bucket_edges=None``.  Any remaining
    kwargs go to :class:`IngestQueue`."""
    if bucket_edges == "auto":
        bucket_edges = None
        first = next(iter(service._streams.values()), None)
        if expected_ks and first is not None:
            c = first.cfg
            bucket_edges = choose_bucket_edges(
                list(expected_ks), c.n2, c.r, c.sketch_l, corange=c.corange,
                machine=probe_machine(service.device))
    return IngestQueue(service, depth=depth, window=window,
                       bucket_edges=bucket_edges, **cfg)
