"""The serving engine of the port (the reference's ``serve/engine.py``):
the repo's two request-serving workloads behind one door.

1. LM serving, dense, MoE, SSM and hybrid families: ``serve_prefill`` /
   ``serve_decode_step`` and :class:`BatchedServer`, a fixed-slot batched
   scheduler (continuous batching without paged memory), run under
   ``torch.inference_mode``.
2. Sketch serving: a :class:`SketchService` on one card or over a grid of
   ranks, and the bounded async :class:`IngestQueue` in front of it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sketch import make_grid_groups
from repro_torch.models import get_api, mamba_lm, transformer, zamba
from repro_torch.models.common import matmul
from repro_torch.obs import trace as obs_trace
from repro_torch.parallel.grad_compress import world_size
from repro_torch.plan.model import choose_bucket_edges, probe_machine
from repro_torch.plan.planner import Plan, plan_sketch
from repro_torch.stream.ingest import IngestQueue
from repro_torch.stream.service import SketchService

# the roadmap item that ports each family the port lacks
_NOT_PORTED = {"encdec": "11d", "vlm": "11d"}


# ---------------------------------------------------------------------------
# LM serving: prefill -> (last-position logits, decode cache)
# ---------------------------------------------------------------------------

def serve_prefill(params, cfg: ModelConfig, batch: Dict[str, Any], *,
                  max_len: Optional[int] = None, remat: bool = True):
    """Process the prompt ``batch["tokens"]`` (B, S); returns the
    last-position logits (B, 1, vocab) and the decode cache.  The SSM and
    hybrid families return ``None`` for the cache, as the reference does:
    their hidden forward has no state prefill (:class:`BatchedServer`
    replays a prompt token by token)."""
    fam = cfg.family
    if fam in ("dense", "moe"):
        return transformer.prefill(params, cfg, batch["tokens"],
                                   remat=remat, max_len=max_len)
    hidden = {"ssm": mamba_lm.mamba_lm_hidden,
              "hybrid": zamba.hybrid_hidden}.get(fam)
    if hidden is None:
        raise NotImplementedError(
            f"{cfg.name}: serving the {fam} family is not ported yet "
            f"(ROADMAP.md Queue 1, item {_NOT_PORTED.get(fam, '11')})")
    with torch.inference_mode():
        h = hidden(params, cfg, batch["tokens"], remat=remat)
        return matmul(h[:, -1:], params["lm_head"].T), None


def serve_decode_step(params, cfg: ModelConfig, token, cache, pos):
    return get_api(cfg).decode_step(params, cfg, token, cache, pos)


# ---------------------------------------------------------------------------
# batched request scheduler (continuous-batching-lite)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchedServer:
    """Fixed-slot batched decoding: requests claim slots; finished slots are
    refilled from the queue each step (continuous batching without paged
    memory: cache slots are per-request rows of the batched cache).

    The reference's semantics, kept exactly: one step of the whole
    ``slots``-row batch advances one slot's token at that slot's own
    position (every row's cache is written at that slot; a row's own
    tokens overwrite it when that row advances), and a claimed slot
    replays its prompt token by token rather than through ``prefill``.
    With MoE the other rows route their tokens (token 0 in an idle or
    waiting row) beside the advancing one and compete with it for the
    step's expert capacity, as in the reference.  With the SSM and hybrid
    families every step advances every row's recurrent state, so an idle
    or waiting row absorbs token 0 whenever another slot advances, as in
    the reference (which has no per-slot state or reset).
    The cache lives on the params' device."""

    def __init__(self, params, cfg: ModelConfig, *, slots: int,
                 max_len: int, eos: int = 1):
        self.params, self.cfg = params, cfg
        self.slots, self.max_len, self.eos = slots, max_len, eos
        self.api = get_api(cfg)
        self.device = params["embed"].device
        self.cache = self.api.init_cache(cfg, slots, max_len,
                                         device=self.device)
        self.pos = [0] * slots
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _fill_slots(self):
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.pop(0)
                self.active[s] = req
                self.pos[s] = 0
                # teacher-forced prompt replay into the cache
                with obs_trace.span("serve.prefill", cat="serve",
                                    rid=req.rid, slot=s,
                                    prompt_len=len(req.prompt)):
                    for t in req.prompt:
                        self._advance_slot(s, t)

    def _advance_slot(self, s: int, token: int) -> int:
        tok = torch.zeros((self.slots, 1), dtype=torch.int64,
                          device=self.device)
        tok[s, 0] = token
        logits, self.cache = self.api.decode_step(
            self.params, self.cfg, tok, self.cache, self.pos[s])
        self.pos[s] += 1
        return int(torch.argmax(logits[s, -1]))

    @torch.inference_mode()
    def step(self) -> bool:
        """One scheduler tick; returns False when idle."""
        with obs_trace.span("serve.step", cat="serve"):
            self._fill_slots()
            busy = False
            for s, req in enumerate(self.active):
                if req is None:
                    continue
                busy = True
                last = req.out[-1] if req.out else req.prompt[-1]
                nxt = self._advance_slot(s, last)
                req.out.append(nxt)
                if nxt == self.eos or len(req.out) >= req.max_new \
                        or self.pos[s] >= self.max_len - 1:
                    req.done = True
                    self.active[s] = None
            return busy or bool(self.queue)

    def run(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.step():
                break


# ---------------------------------------------------------------------------
# batched sketch service (streaming workload entry point)
# ---------------------------------------------------------------------------


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
