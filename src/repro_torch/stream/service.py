"""Batched sketch service: many concurrent streams on one card, or sharded
over a grid of ranks (the port of the reference's ``stream/service.py``).

Each client stream owns its own (Y, W) accumulators on the device plus a
Philox key pair; opening stream number 1000 costs two allocations, not a
compile.  Every update writes into the stream's own ``Y`` and ``W`` IN
PLACE, which is the torch counterpart of the reference's JAX donation: the
reference's stacked cohorts, lane-count snapping and dummy lanes existed
only to bound XLA compiles, and have no counterpart here.

Multi-tenant ingest:

  * ``update``        — one stream's row slab (``stream.state.rowblock_update``).
  * ``update_batch``  — same-shape lanes of many streams, one fold launch.
  * ``update_ragged`` — heterogeneous row slabs (the hot path).  Lanes are
    grouped by (shape signature, bucket height), the bucket height being
    ``snap_bucket(k_i, bucket_edges)`` (pow2 by default).  Per bucket the
    lanes are staged into ONE pinned host buffer padded with
    ``pad_value`` and copied to the card in one transfer; then
    ``stream.state.local_rowblock_ragged`` runs a ``sketch_fwd`` per lane
    into an f32 ``dY`` buffer, ONE lane-batched K4 fold into the lanes'
    own ``Y`` (device arrays of lane pointers, offsets and valid-row
    counts; no host sync, no stacking copy) and a ``sketch_t`` per lane
    into ``W``.  Lane i is bitwise the result of updating stream i alone
    through ``update``, whatever the pad rows hold (NaN included), for
    float32 and bfloat16 streams.

Admission/eviction: streams carry a QoS class (``pinned`` > ``standard`` >
``best_effort``).  With ``max_resident`` set, opening or touching a stream
beyond the budget evicts the coldest non-pinned resident — its (Y, W) is
copied to host memory, or with ``spill_dir`` written to disk
(``checkpoint.ckpt``, ``spill_dir/stream_<sid>``; in grid mode each rank
its own blocks under ``spill_dir/rank_<rank>``), and restored bitwise on
next touch.  A spill that fails to write or read raises: it never falls
back to host memory.

Two placement modes:

  * ``mesh=None`` — local mode, as above.
  * ``mesh=make_grid_groups(p1, p2, p3)`` — grid mode.  Every rank of the
    grid runs the same service calls; each stream's state is this rank's
    blocks (``stream.distributed``: Y in Alg. 1's output layout, W in
    P(None, (p2, p3))), and ``update`` takes full-shape deltas only,
    running ``ShardedStreamingSketch.update``'s body with the stream's
    key pair (Alg. 1's collectives plus the co-range all-reduce, counted
    in ``parallel.collectives.COMM``).  ``nystrom`` runs the Alg. 2 second
    stages on a (P, 1, 1) grid; eviction copies each rank's own blocks.
    The lane-batched updates are local-mode only.  ``reshard(new_grid)``
    moves every stream, resident or evicted, onto another grid
    (``stream/elastic.py``); a rank past a smaller grid keeps a standby
    service, whose streams hold no block: their updates are counted and
    do nothing, their queries raise.

Sparse payloads (local mode only, as in the reference):

  * ``update_sparse``       — one stream's COO row slab (``SparseRows``):
    ``stream.state.sparse_rowblock_update``, on the card the S1 kernel
    (``kernels/csrc/sparse_kernels.cu``), bitwise the reference's scatter.
  * ``update_sparse_batch`` — one COO slab a lane, lanes of one shape
    signature and slab height; lane i is bitwise ``update_sparse`` of
    stream i alone.

With a ledger installed (``obs.ledger``) every ingest path is a comm-ledger
site under the reference's name: ``service.update[dist]`` (against
:meth:`SketchService._dist_audit`), ``service.update[local]``,
``service.update_batch`` and ``service.update_ragged`` (observed: 0 words
predicted at a 0 floor on one device) and ``service.update[sparse]`` (an
analytic record of the COO payload's ``2·nnz`` words).

"""
from __future__ import annotations

import dataclasses
import itertools
import os
import shutil
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.sketch import gather_output, resolve_device, seed_keys
from repro_torch.obs import ledger as obs_ledger
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

from .distributed import (_grid_of, check_divisible, gather_corange,
                          nystrom_finalize, refuse_sparse, sharded_update,
                          standby_error, stream_blocks, update_audit)
from .state import (SparseRows, StreamConfig, _local_sig,
                    local_rowblock_ragged, local_sparse_batch, nystrom_local,
                    rowblock_update, snap_bucket, sparse_rowblock_update,
                    validate_row_block)

_BATCH_WHY = ("distributed streams already amortize dispatch through the "
              "shared mesh program")
_SPARSE_WHY = ("distributed sparse bodies are deferred, as in the reference "
               "— densify and use update(), or open the stream on a local "
               "service")

#: QoS classes, strongest first.  ``pinned`` streams are never auto-evicted;
#: among evictable residents the lowest class goes first, LRU within class.
QOS_CLASSES = ("pinned", "standard", "best_effort")
_EVICT_RANK = {"best_effort": 0, "standard": 1}


@dataclasses.dataclass
class _Stream:
    cfg: StreamConfig
    keys: Tuple[int, int]    # Philox key pair
    Y: torch.Tensor
    W: Optional[torch.Tensor]
    num_updates: int = 0
    qos: str = "standard"
    last_touch: int = 0


@dataclasses.dataclass
class _Evicted:
    """A stream whose accumulators left the device, for host memory
    (``host``) or for a checkpoint on disk (``path``): everything needed
    to rebuild the resident ``_Stream`` bitwise."""
    cfg: StreamConfig
    keys: Tuple[int, int]
    qos: str
    num_updates: int
    host: Optional[Dict[str, torch.Tensor]] = None
    path: Optional[str] = None


def _host_slab(H) -> torch.Tensor:
    """A request payload (numpy array or tensor) as a tensor; a numpy
    array is shared, unless it is read-only (a replayed journal record)."""
    if isinstance(H, torch.Tensor):
        return H
    H = np.asarray(H)
    return torch.from_numpy(H if H.flags.writeable else H.copy())


class SketchService:
    """Many concurrent sketch streams on one device.

    >>> svc = SketchService(max_resident=1000)      # device=None: the card
    >>> sid = svc.open(StreamConfig(n1=256, n2=512, r=32, seed=7))
    >>> svc.update(sid, H, row0=0)                   # rows arrive
    >>> svc.update_ragged([(sid, H2, 64)])           # or fused with others
    >>> svc.sketch(sid)                              # the live Y = A·Omega
    >>> svc.reconstruct(sid, rank=16)                # one-pass estimate

    ``mesh`` (a ``core.sketch.make_grid_groups`` grid holding this rank,
    or a ``repro_torch.plan.Plan`` whose grid becomes one) selects grid
    mode; ``device=None`` means the card.  ``spill_dir`` sends evicted
    streams to disk instead of host memory.
    """

    def __init__(self, mesh=None, max_resident: Optional[int] = None,
                 spill_dir: Optional[str] = None, device=None):
        self.mesh = None if mesh is None else _grid_of(mesh)
        if max_resident is not None and max_resident < 1:
            raise ValueError("max_resident must be >= 1")
        self.device = resolve_device(device)
        self.max_resident = max_resident
        self.spill_dir = spill_dir
        self._streams: Dict[int, _Stream] = {}
        self._evicted: Dict[int, _Evicted] = {}
        self._sid = itertools.count()
        self._clock = itertools.count(1)    # LRU clock for eviction
        self._updates_total = 0             # service-lifetime, survives close
        self._lane_batches = 0              # one per fold launch
        self._audit: Dict[Tuple, Tuple[float, float]] = {}
        m = obs_metrics.get_metrics()
        self._m_updates = m.counter(
            "sketch_updates_total", "stream updates applied, by ingest path")
        self._m_evictions = m.counter(
            "sketch_evictions_total", "streams checkpointed off-device")
        self._m_spills = m.counter(
            "sketch_spills_total", "evictions written to disk (spill_dir)")
        self._m_restores = m.counter(
            "sketch_restores_total", "evicted streams restored from their "
            "checkpoint")
        self._m_resident = m.gauge(
            "sketch_resident_streams", "streams currently resident on device")
        self._m_real_rows = m.counter(
            "sketch_ragged_real_rows_total",
            "real rows folded by update_ragged")
        self._m_padded_rows = m.counter(
            "sketch_ragged_padded_rows_total",
            "pad rows staged by update_ragged (n·kb − real per bucket)")

    # -- lifecycle ---------------------------------------------------------

    def open(self, cfg: StreamConfig, qos: str = "standard") -> int:
        if qos not in QOS_CLASSES:
            raise ValueError(f"qos {qos!r} not in {QOS_CLASSES}")
        cfg.validate()
        if self.mesh is not None:
            refuse_sparse(cfg)
            check_divisible(cfg, self.mesh)
        self._admit(need=1)
        if self._standby:
            Y = W = None
        elif self.mesh is not None:
            blocks = stream_blocks(cfg, self.mesh, device=self.device)
            Y, W = blocks["Y"], blocks["W"]
        else:
            Y = torch.zeros((cfg.n1, cfg.r), dtype=cfg.dtype,
                            device=self.device)
            W = (torch.zeros((cfg.sketch_l, cfg.n2), dtype=cfg.dtype,
                             device=self.device)
                 if cfg.corange else None)
        sid = next(self._sid)
        self._streams[sid] = _Stream(cfg, seed_keys(cfg.seed), Y, W, qos=qos,
                                     last_touch=next(self._clock))
        self._m_resident.set(len(self._streams))
        return sid

    def close(self, sid: int):
        """Finalize: returns the stream's final (Y, W) — W is None for
        corange=False streams — and frees the slot (an evicted stream is
        restored first, so the returned state is on the device)."""
        ev = self._evicted.get(sid)
        if ev is not None:
            st = self._restore(ev)
            del self._evicted[sid]
            return st.Y, st.W
        st = self._streams.pop(sid, None)
        if st is None:
            raise ValueError(f"unknown stream id {sid} (never opened, or "
                             f"already closed)")
        self._m_resident.set(len(self._streams))
        return st.Y, st.W

    # -- admission / eviction ----------------------------------------------

    def _touch(self, sid: int, protect=frozenset()) -> _Stream:
        """Resolve ``sid`` to its resident stream, restoring it from host
        memory if it was evicted, and bump its LRU clock.  Raises a clear
        ValueError for unknown (never-opened/closed) sids."""
        st = self._streams.get(sid)
        if st is None:
            ev = self._evicted.pop(sid, None)
            if ev is None:
                raise ValueError(f"unknown stream id {sid} (never opened, "
                                 f"or already closed)")
            try:
                self._admit(need=1, protect=protect)
                st = self._restore(ev)
            except Exception:
                self._evicted[sid] = ev     # leave the stream restorable
                raise
            self._streams[sid] = st
            self._m_resident.set(len(self._streams))
        st.last_touch = next(self._clock)
        return st

    def _admit(self, need: int, protect=frozenset()) -> None:
        """Evict coldest non-pinned residents (LRU within QoS class, lowest
        class first) until ``need`` more streams fit under ``max_resident``.
        Raises RuntimeError when the budget cannot be met (everything
        resident is pinned or belongs to the in-flight batch)."""
        if self.max_resident is None:
            return
        while len(self._streams) + need > self.max_resident:
            victims = [(sid, st) for sid, st in self._streams.items()
                       if st.qos != "pinned" and sid not in protect]
            if not victims:
                raise RuntimeError(
                    f"admission refused: all {len(self._streams)} resident "
                    f"streams are pinned or in-flight and max_resident="
                    f"{self.max_resident}")
            sid, _ = min(victims, key=lambda kv: (_EVICT_RANK[kv[1].qos],
                                                  kv[1].last_touch))
            self.evict(sid)

    def evict(self, sid: int) -> None:
        """Move a resident stream's (Y, W) — in grid mode this rank's
        blocks — off the device, to host memory or, with ``spill_dir``, to
        disk, and free its device slot.  The next touch restores it
        bitwise.  A failed spill raises and leaves the stream resident."""
        st = self._streams.get(sid)
        if st is None:
            if sid in self._evicted:
                return                      # idempotent
            raise ValueError(f"unknown stream id {sid} (never opened, or "
                             f"already closed)")
        with obs_trace.span("service.evict", cat="service", sid=sid,
                            spill=self.spill_dir is not None):
            ev = _Evicted(st.cfg, st.keys, st.qos, st.num_updates)
            if self._stash(sid, ev, self._blocks(st.Y, st.W)):
                self._m_spills.inc()
            del self._streams[sid]
            self._evicted[sid] = ev
        self._m_evictions.inc()
        self._m_resident.set(len(self._streams))

    @staticmethod
    def _blocks(Y, W) -> Dict[str, torch.Tensor]:
        """A stream's accumulators by name (none on a standby rank)."""
        return {k: v for k, v in (("Y", Y), ("W", W)) if v is not None}

    def _spill_path(self, sid: int) -> str:
        if self.mesh is None:
            return os.path.join(self.spill_dir, f"stream_{sid:08d}")
        import torch.distributed as dist
        return os.path.join(self.spill_dir, f"rank_{dist.get_rank():05d}",
                            f"stream_{sid:08d}")

    def _stash(self, sid: int, ev: _Evicted,
               blocks: Dict[str, torch.Tensor]) -> bool:
        """Keep ``blocks`` of an evicted stream off the device: with
        ``spill_dir`` on disk (``ckpt.save`` of ``{Y, W}``, step
        ``num_updates``, ``keep=1``; True), else in host memory."""
        if self.spill_dir is None or not blocks:
            ev.host, ev.path = {k: v.cpu() for k, v in blocks.items()}, None
            return False
        from repro_torch.checkpoint import ckpt
        path = self._spill_path(sid)
        ckpt.save(path, ev.num_updates, blocks, extra={
            "config": ev.cfg.to_json_dict(), "qos": ev.qos,
            "num_updates": ev.num_updates}, keep=1)
        ev.host, ev.path = None, path
        return True

    def _unstash(self, ev: _Evicted) -> Dict[str, torch.Tensor]:
        """An evicted stream's blocks, on the CPU; a spilled stream's
        directory is removed once they are read."""
        if ev.path is None:
            return ev.host
        from repro_torch.checkpoint import ckpt
        tensors, _, _ = ckpt.restore_tree(ev.path, ev.num_updates)
        shutil.rmtree(ev.path, ignore_errors=True)
        return tensors

    def _restore(self, ev: _Evicted) -> _Stream:
        tree = {k: v.to(self.device) for k, v in self._unstash(ev).items()}
        self._m_restores.inc()
        return _Stream(ev.cfg, ev.keys, tree.get("Y"), tree.get("W"),
                       num_updates=ev.num_updates, qos=ev.qos)

    @property
    def _standby(self) -> bool:
        """True on a rank past the service's grid (after a reshard)."""
        return self.mesh is not None and self.mesh.coords is None

    def _resident(self, sid: int, what: str) -> _Stream:
        """The stream ``sid`` for a query, which a standby rank refuses."""
        st = self._touch(sid)
        if self._standby:
            raise standby_error(what, self.mesh)
        return st

    def _dist_audit(self, cfg: StreamConfig) -> Tuple[float, float]:
        """(planner-predicted words, Theorem-2 floor) of ONE full-shape
        grid-mode update — the ledger's reference numbers for
        ``service.update[dist]`` (the reference's ``_dist_audit``):
        ``stream.distributed.update_audit`` of a full-shape update, as
        ``ShardedStreamingSketch`` prices it.  Memoized per stream
        signature."""
        key = _local_sig(cfg)
        hit = self._audit.get(key)
        if hit is None:
            hit = self._audit[key] = update_audit(cfg, self.mesh.shape)
        return hit

    # -- ingest ------------------------------------------------------------

    def update(self, sid: int, H, row0: Optional[int] = None):
        """Apply one update to stream ``sid``.

        Local mode: ``row0`` selects a row-block update (H is (k, n2));
        ``row0=None`` means a full-shape additive delta.  Grid mode takes
        full-shape additive deltas only, the same on every rank.
        """
        st = self._touch(sid)
        cfg = st.cfg
        if self.mesh is not None and row0 is not None:
            raise ValueError("distributed streams take full-shape "
                             "additive updates (row0 must be None)")
        H = _host_slab(H)
        if not self._standby:
            H = H.to(device=self.device, dtype=cfg.dtype)
        if row0 is None:
            if tuple(H.shape) != (cfg.n1, cfg.n2):
                raise ValueError(f"{tuple(H.shape)} != ({cfg.n1}, "
                                 f"{cfg.n2})")
            if self._standby:
                return self._applied(st, "dist")
            if self.mesh is not None:
                with (obs_ledger.observing("service.update[dist]",
                                           (st.Y, st.W, H, self.mesh.shape),
                                           self._dist_audit, (cfg,),
                                           itemsize=cfg.dtype.itemsize),
                      obs_trace.span("service.update", cat="service",
                                     mode="dist")):
                    sharded_update(cfg, st.keys, st.Y, st.W, H, self.mesh)
                return self._applied(st, "dist")
            row0 = 0
        row0 = int(row0)
        validate_row_block(cfg, row0, tuple(H.shape))
        # local mode: predicted AND floor are 0 words (one device) — the
        # ledger checks that the update moves nothing
        with (obs_ledger.observing("service.update[local]", (st.Y, st.W, H),
                                   itemsize=cfg.dtype.itemsize),
              obs_trace.span("service.update", cat="service",
                             mode="local")):
            rowblock_update(cfg, st.keys, st.Y, st.W, row0, H)
        return self._applied(st, "single")

    def _applied(self, st: _Stream, path: str):
        self._m_updates.inc(path=path)
        st.num_updates += 1
        self._updates_total += 1
        return self

    def update_sparse(self, sid: int, sp: SparseRows, row0: int = 0):
        """Apply one COO row-slab update to stream ``sid`` (local mode).

        The payload is (indices + values), ``2·nnz`` words
        (``plan.model.sparse_payload_words``) instead of the dense slab's
        ``k·n2``; the fold is ``stream.state.sparse_rowblock_update`` (on
        the card the S1 kernel), bitwise the reference's.  The payload is
        recorded at the ``service.update[sparse]`` ledger site, an
        analytic one, as in the reference.
        """
        self._local_only("update_sparse", _SPARSE_WHY)
        st = self._touch(sid)
        row0 = int(row0)
        sp.validate(st.cfg, row0)
        self._record_sparse(st.cfg, sp.nnz, ("nnz", sp.nnz))
        with obs_trace.span("service.update", cat="service", mode="sparse"):
            sparse_rowblock_update(st.cfg, st.keys, st.Y, st.W, row0, sp)
        return self._applied(st, "sparse")

    def update_sparse_batch(self, sids, sps, row0=0):
        """Multi-stream sparse ingest: one COO slab into every stream in
        ``sids`` (local mode).

        All lanes share one shape signature and one slab height; ``row0``
        is one offset for all lanes or one a lane.  Each lane owns its
        destinations and nothing is summed across lanes, so lane i is
        bitwise :meth:`update_sparse` of stream i alone
        (``stream.state.local_sparse_batch``: two S1 launches a lane on the
        card).  The lanes' payloads are recorded together at the
        ``service.update[sparse]`` ledger site, as in the reference.
        """
        self._local_only("update_sparse_batch", _SPARSE_WHY)
        sids = list(sids)
        if len(set(sids)) != len(sids):
            raise ValueError("update_sparse_batch sids must be distinct")
        protect = frozenset(sids)
        sts = [self._touch(s, protect) for s in sids]
        if not sts:
            raise ValueError("update_sparse_batch needs at least one stream")
        sps = list(sps)
        if len(sps) != len(sts):
            raise ValueError(f"need {len(sts)} payloads, got {len(sps)}")
        sig = _local_sig(sts[0].cfg)
        for st in sts[1:]:
            if _local_sig(st.cfg) != sig:
                raise ValueError(
                    f"streams must share one shape signature; "
                    f"{_local_sig(st.cfg)} != {sig}")
        n = len(sts)
        row0s = ([int(row0)] * n if np.ndim(row0) == 0
                 else [int(x) for x in row0])
        if len(row0s) != n:
            raise ValueError(f"row0 needs {n} entries, got {len(row0s)}")
        k = sps[0].shape[0]
        for sp, r0 in zip(sps, row0s):
            if sp.shape[0] != k:
                raise ValueError(f"lanes must share one slab height; "
                                 f"{sp.shape[0]} != {k}")
            sp.validate(sts[0].cfg, r0)
        tot = sum(sp.nnz for sp in sps)
        self._record_sparse(sts[0].cfg, tot, ("nnz", tot, "lanes", n))
        with obs_trace.span("service.update_sparse_batch", cat="service",
                            lanes=n):
            local_sparse_batch([(st.cfg, st.keys, st.Y, st.W, r0)
                                for st, r0 in zip(sts, row0s)], sps)
        self._m_updates.inc(n, path="sparse")
        for st in sts:
            st.num_updates += 1
        self._updates_total += n
        return self

    @staticmethod
    def _record_sparse(cfg: StreamConfig, nnz: int, detail) -> None:
        """The ``service.update[sparse]`` record: the COO payload's
        ``sparse_payload_words(nnz)`` predicted, ``nnz`` the floor."""
        led = obs_ledger.get_ledger()
        if led is not None:
            from repro_torch.plan.model import sparse_payload_words
            led.record("service.update[sparse]",
                       predicted_words=sparse_payload_words(nnz),
                       lower_bound_words=float(nnz),
                       itemsize=cfg.dtype.itemsize, detail=detail)

    def _local_only(self, what: str, why: str = _BATCH_WHY) -> None:
        if self.mesh is not None:
            raise NotImplementedError(f"{what} is local-mode only; {why}")

    def _lanes(self, sids) -> list:
        """Touch every lane of a batch (none may evict a sibling)."""
        sids = list(sids)
        if len(set(sids)) != len(sids):
            raise ValueError("batch sids must be distinct (duplicate lanes "
                             "would overwrite each other's update)")
        if not sids:
            raise ValueError("a batch update needs at least one stream")
        protect = frozenset(sids)
        return [self._touch(s, protect) for s in sids]

    def _apply_lanes(self, group, Hb: torch.Tensor, path: str) -> None:
        """Run one staged bucket: ``group`` is [(stream, row0, k)]."""
        local_rowblock_ragged(
            [(st.cfg, st.keys, st.Y, st.W, row0, k) for st, row0, k in group],
            Hb)
        n = len(group)
        self._m_updates.inc(n, path=path)
        for st, _, _ in group:
            st.num_updates += 1
        self._updates_total += n
        self._lane_batches += 1

    def update_batch(self, sids, H, row0=0):
        """Fused multi-stream ingest: the same-shape row-block update
        applied to every stream in ``sids``.

        H    : (N, k, n2) — lane i is the update for stream ``sids[i]``.
        row0 : int applied to all lanes, or a length-N sequence of
               per-lane offsets.

        Lane i's result is bitwise the result of updating stream i alone;
        all lanes share one fold launch.  For heterogeneous lane shapes
        use :meth:`update_ragged`.  Local mode only.
        """
        self._local_only("update_batch")
        sts = self._lanes(sids)
        cfg0 = sts[0].cfg
        sig = _local_sig(cfg0)
        for st in sts[1:]:
            if _local_sig(st.cfg) != sig:
                raise ValueError(f"streams must share one shape signature; "
                                 f"{_local_sig(st.cfg)} != {sig}")
        n = len(sts)
        H = _host_slab(H)
        if H.dim() != 3 or H.shape[0] != n:
            raise ValueError(f"H must be (N={n}, k, n2); got "
                             f"{tuple(H.shape)}")
        row0s = ([int(row0)] * n if np.ndim(row0) == 0
                 else [int(x) for x in row0])
        if len(row0s) != n:
            raise ValueError(f"row0 needs {n} entries, got {len(row0s)}")
        for r0 in row0s:
            validate_row_block(cfg0, r0, tuple(H.shape[1:]))
        k = H.shape[1]
        Hb = H.to(device=self.device, dtype=cfg0.dtype).contiguous()
        with (obs_ledger.observing("service.update_batch",
                                   (sts[0].Y, sts[0].W, Hb),
                                   itemsize=cfg0.dtype.itemsize),
              obs_trace.span("service.update_batch", cat="service",
                             lanes=n)):
            self._apply_lanes([(st, r0, k) for st, r0 in zip(sts, row0s)],
                              Hb, "batch")
        return self

    def _stage(self, group, kb: int, cfg: StreamConfig,
               pad_value: float) -> torch.Tensor:
        """Lanes' slabs in one (n, kb, n2) buffer padded with
        ``pad_value``: pinned host memory and ONE host-to-device copy when
        the service is on the card."""
        pin = self.device.type == "cuda"
        Hb = torch.empty((len(group), kb, cfg.n2), dtype=cfg.dtype,
                         pin_memory=pin)
        for i, (_, H, _, k) in enumerate(group):
            Hb[i, :k].copy_(H)
            if k < kb:
                Hb[i, k:].fill_(pad_value)
        return Hb.to(self.device, non_blocking=True)

    def update_ragged(self, items: Sequence[Tuple[int, Any, int]], *,
                      bucket_edges: Optional[Sequence[int]] = None,
                      pad_value: float = 0.0):
        """Fused HETEROGENEOUS multi-stream ingest (the multi-tenant hot
        path): each item is ``(sid, H, row0)`` with its own row-slab shape
        ``(k_i, n2)`` and offset.

        Lanes are grouped by (shape signature, bucket height), the bucket
        height being ``snap_bucket(k_i, bucket_edges)`` (pow2 by default);
        each bucket is staged once and runs
        ``stream.state.local_rowblock_ragged`` (one fold launch).  Every
        lane is validated before any stream is mutated.

        Pad rows are never read: lane i's result is bitwise the result of
        updating stream i alone via :meth:`update`, whatever ``pad_value``
        holds (NaN included — that is how the contract is tested), for
        float32 and bfloat16 streams.  The ``sketch_ragged_padded_rows_total``
        counter adds ``n·kb − real`` per bucket (the staged pad rows).
        Local mode only.
        """
        self._local_only("update_ragged")
        items = list(items)
        sts = self._lanes(it[0] for it in items)
        edges = None if bucket_edges is None else sorted(
            int(e) for e in bucket_edges)
        buckets: Dict[Tuple, list] = {}
        for st, (_, H, row0) in zip(sts, items):
            cfg = st.cfg
            H = _host_slab(H)
            row0 = int(row0)
            validate_row_block(cfg, row0, tuple(H.shape))
            k = H.shape[0]
            kb = snap_bucket(k, edges)
            if kb > cfg.n1:
                kb = k      # never stage a frame taller than the stream
            buckets.setdefault((_local_sig(cfg), kb), []).append(
                (st, H, row0, k))
        for (_, kb), group in buckets.items():
            n = len(group)
            st0, cfg = group[0][0], group[0][0].cfg
            with (obs_ledger.observing(
                    "service.update_ragged",
                    (st0.Y, st0.W, (n, kb, cfg.n2), cfg.dtype),
                    itemsize=cfg.dtype.itemsize),
                  obs_trace.span("service.update_ragged", cat="service",
                                 lanes=n, bucket=kb)):
                Hb = self._stage(group, kb, cfg, pad_value)
                self._apply_lanes([(st, row0, k) for st, _, row0, k in group],
                                  Hb, "ragged")
            real = sum(g[3] for g in group)
            self._m_real_rows.inc(real)
            self._m_padded_rows.inc(n * kb - real)
        return self

    def sync(self):
        """Block until every in-flight device update has landed (the
        serving loop's barrier)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def reshard(self, new_grid: Tuple[int, int, int]) -> int:
        """Move every stream onto ``new_grid`` (every rank of the world
        calls it): each resident stream in one hop
        (``stream.elastic.hop``), and each evicted stream's blocks, from
        host memory or disk, the same way, so that its next touch lands
        on the new layout.  No recompute, no replay.

        The ``elastic.reshard`` fault point fires and the new grid is
        checked against every stream before any block moves.  A rank past
        the new grid keeps a standby service.  Callers pausing live
        ingest go through ``stream.elastic.drain_reshard_resume``.
        Returns the number of resident streams moved."""
        if self.mesh is None:
            raise ValueError("reshard needs a distributed service "
                             "(mesh=None is single-device)")
        from repro_torch.core.sketch import make_grid_groups

        from . import elastic, faults
        old = self.mesh
        new_grid = tuple(int(g) for g in new_grid)
        faults.fire("elastic.reshard", old_grid=old.shape,
                    new_grid=new_grid)
        for st in list(self._streams.values()) + list(
                self._evicted.values()):
            check_divisible(st.cfg, new_grid)
        new = make_grid_groups(*new_grid)
        with obs_trace.span("service.reshard", cat="service",
                            old="x".join(map(str, old.shape)),
                            new="x".join(map(str, new_grid))):
            self.sync()
            for sid in sorted(self._streams):
                st = self._streams[sid]
                st.Y, st.W = elastic.hop(st.cfg, old, new, st.Y, st.W,
                                         self.device)
            self.mesh = new
            for sid in sorted(self._evicted):
                ev = self._evicted[sid]
                blocks = self._unstash(ev)
                Y, W = elastic.move_blocks(ev.cfg, old, new, blocks.get("Y"),
                                           blocks.get("W"),
                                           torch.device("cpu"))
                self._stash(sid, ev, self._blocks(Y, W))
        self._audit.clear()
        return len(self._streams)

    # -- queries -----------------------------------------------------------

    def sketch(self, sid: int) -> torch.Tensor:
        """The live Y (in grid mode this rank's block)."""
        return self._resident(sid, "sketch").Y

    def corange(self, sid: int) -> Optional[torch.Tensor]:
        """The live W (in grid mode this rank's block)."""
        return self._resident(sid, "corange").W

    def reconstruct(self, sid: int, rank: Optional[int] = None, rcond=None):
        """One-pass estimate (grid mode: from the gathered Y and W, on
        every rank)."""
        from .reconstruct import one_pass_reconstruct
        st = self._resident(sid, "reconstruct")
        if st.W is None:
            raise ValueError("reconstruction needs corange=True")
        Y, W = st.Y, st.W
        if self.mesh is not None:
            Y, W = gather_output(Y, self.mesh), gather_corange(W, self.mesh)
        return one_pass_reconstruct(Y, W, st.cfg, rank=rank, rcond=rcond)

    def nystrom(self, sid: int, variant: str = "auto"):
        """(B, C) of a symmetric stream: local mode C = Omega^T·Y from the
        sketch; grid mode the Alg. 2 second stages on a (P, 1, 1) grid,
        ``variant`` ``auto`` / ``no_redist`` / ``redist`` /
        ``bound_driven`` (``stream.distributed.nystrom_finalize``)."""
        st = self._resident(sid, "nystrom")
        if st.cfg.n1 != st.cfg.n2:
            raise ValueError("Nyström needs a square stream")
        if self.mesh is not None:
            return nystrom_finalize(st.Y, st.cfg, self.mesh, variant)
        return nystrom_local(st.Y, st.cfg)

    # -- introspection -----------------------------------------------------

    @property
    def num_streams(self) -> int:
        """Open streams — resident plus evicted-but-restorable."""
        return len(self._streams) + len(self._evicted)

    @property
    def num_resident(self) -> int:
        return len(self._streams)

    @property
    def num_evicted(self) -> int:
        return len(self._evicted)

    def stats(self) -> Dict[str, int]:
        """Residency, the service-lifetime update count (closing a stream
        does not take its updates away) and ``lane_batches``, the lifetime
        count of lane-batched updates (one per ``update_batch`` call and
        one per bucket of ``update_ragged``; each runs one fold).  The
        reference's ``compiled_updates`` has no counterpart: nothing is
        compiled."""
        return {"streams": self.num_streams,
                "resident": self.num_resident,
                "evicted": self.num_evicted,
                "updates": self._updates_total,
                "lane_batches": self._lane_batches}
