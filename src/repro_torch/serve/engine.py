"""The sketch-serving entry points (the sketch half of the reference's
``serve/engine.py``): a :class:`SketchService` on one card or over a grid
of ranks, and the bounded async :class:`IngestQueue` in front of it."""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.sketch import make_grid_groups
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
            "repro_torch yet (ROADMAP Queue 1 item 7); pass a (p1, p2, p3) "
            "grid")
    mesh = None if grid is None else make_grid_groups(*grid)
    return SketchService(mesh=mesh, max_resident=max_resident,
                         spill_dir=spill_dir, device=device)


def make_ingest_queue(service: SketchService, depth: int = 256,
                      window: int = 64,
                      bucket_edges: Optional[Sequence[int]] = None,
                      **cfg) -> IngestQueue:
    """Front a service with the bounded async queue.  ``bucket_edges=None``
    snaps lanes to pow2 buckets; ``"auto"`` (the reference's
    planner-priced edges) waits for the planner port and raises.  Any
    remaining kwargs go to :class:`IngestQueue`."""
    if bucket_edges == "auto":
        raise NotImplementedError(
            'bucket_edges="auto" needs the planner\'s choose_bucket_edges, '
            "not ported to repro_torch yet (ROADMAP Queue 1 item 7)")
    return IngestQueue(service, depth=depth, window=window,
                       bucket_edges=bucket_edges, **cfg)
