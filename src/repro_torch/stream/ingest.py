"""Async multi-tenant ingest queue: the request-facing front half of the
sketch service (the port of the reference's ``stream/ingest.py``), for a
local or a grid-mode service.

``IngestQueue`` sits between request handlers and a
:class:`~repro_torch.stream.service.SketchService`.  Handlers call
:meth:`submit` (cheap: validate + journal + enqueue); a single worker
thread drains the queue in windows, splits each window into rounds with at
most one update per stream (per-stream FIFO order is preserved — sketch
updates commute across streams but not within one), and applies every
round through ONE fused :meth:`SketchService.update_ragged` call (local
mode).

Grid mode (a service with a ``mesh``): every rank runs its own queue and
worker, and every update is collective, so every rank must issue the same
sequence of ``service.update`` calls whatever its windows turned out to
be.  The worker therefore applies a grid service's requests one at a time
in the order they were submitted (seqno order with a WAL), each through
``service.update(sid, H)``; a round is a run of consecutive requests with
at most one a stream.  ``submit`` refuses a ``row0`` other than 0 there
(grid streams take full-shape additive updates).  The ``ingest.dispatch_lane``
fault point fires before each lane, and the lanes not yet applied are kept
in a pending list, so a retry or the poison-lane fallback re-runs only
those (exactly once per lane).  Arming a fault point on one rank of a
multi-rank grid is out of scope: the ranks' collectives would part ways
(the reference's own grid-mode tests run on a (1,1,1) mesh).

A round counts as applied when its kernels have finished on the card (the
worker waits for them with ``service.sync()``), so the latency it records
is submit -> landed, and ``flush`` returns with the card idle.  The price
is that the worker stages round R+1 only after round R's kernels are done;
overlapping the two is left to a later change.  The queue is BOUNDED: when the card falls behind,
``submit`` blocks (backpressure) rather than dropping updates, and raises
``queue.Full`` only when the caller's timeout expires.

Fault model (the reference's):

  * non-finite payloads are rejected at submit time, before anything can
    touch (Y, W);
  * with a :class:`~repro_torch.stream.wal.WriteAheadLog` attached
    (``wal=``), every accepted submit is journaled (fsynced) before it is
    enqueued — replaying the journal onto a fresh service reproduces
    (Y, W) BITWISE;
  * an unexpected worker-thread death fails fast: ``submit`` / ``flush`` /
    ``close_stream`` raise :class:`WorkerDied` carrying the original
    traceback instead of blocking forever;
  * failed rounds are retried with exponential backoff under a deadline
    (``ingest_retries_total``); when retries exhaust, the round falls back
    to per-lane application and only the poison lane is excised
    (``ingest_quarantined_total``) — the other tenants' updates land.  A
    fused round validates every lane before mutating any stream, so a
    failed round left no partial state; a grid round keeps the lanes that
    landed; either way every lane applies once;
  * worker-side failures are recorded per request and surfaced by
    ``flush(raise_errors=True)`` / ``stats()``, never silently swallowed;
  * a kernel launch the card refused
    (:class:`~repro_torch.kernels.sketch_matmul.KernelLaunchError`) is not
    transient and may leave a round half applied: it is neither retried
    nor re-applied lane by lane; it kills the worker, and ``submit`` /
    ``flush`` raise :class:`WorkerDied`.
"""
from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.kernels.sketch_matmul import KernelLaunchError
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

from . import faults
from .state import snap_bucket


class WorkerDied(RuntimeError):
    """The ingest worker thread died unexpectedly.  Raised (fast) by
    ``submit`` / ``flush`` / ``close_stream`` instead of blocking on a
    queue nobody will ever drain.  ``traceback_text`` carries the worker's
    original traceback; it is also appended to ``str(exc)``."""

    def __init__(self, msg: str, traceback_text: str = ""):
        self.traceback_text = traceback_text
        if traceback_text:
            msg = f"{msg}\n--- worker traceback ---\n{traceback_text}"
        super().__init__(msg)


def _percentile(xs: Sequence[float], q: float) -> float:
    """Percentile of a latency window; 0.0 on an empty or all-non-finite
    window (sustained dashboards poll stats() between drains, so the
    window is legitimately empty/short at any moment — never raise)."""
    if xs is None or len(xs) == 0:
        return 0.0
    a = np.asarray(xs, np.float64)
    a = a[np.isfinite(a)]
    if a.size == 0:
        return 0.0
    return float(np.percentile(a, q))


class IngestQueue:
    """Bounded async ingest front-end for a SketchService.

    Parameters
    ----------
    service : SketchService; a local service takes every round through
        its fused ragged hot path, a grid service one lane at a time.
    depth : int — queue capacity; a full queue blocks ``submit``
        (backpressure)
    window : int — max requests fused per drain (one or more rounds)
    bucket_edges : optional ascending bucket tops forwarded to
        ``update_ragged`` (None: pow2 snapping)
    validate_payloads : bool — reject non-finite H at submit time
    wal : optional :class:`~repro_torch.stream.wal.WriteAheadLog` — journal
        every accepted submit before enqueue (crash-safe ingest); the
        applied watermark advances as rounds land and the journal is
        truncated every ``wal_truncate_every`` drained batches
    max_retries : int — whole-round retries on transient failure before
        the per-lane poison-excision fallback
    backoff_base : float — first retry sleeps ``backoff_base`` seconds,
        doubling per attempt (exponential backoff)
    retry_deadline : optional float — wall-clock budget (seconds) for one
        round's retries; when exceeded, remaining retries are forfeited
        and the fallback runs immediately
    """

    def __init__(self, service, depth: int = 256, window: int = 64,
                 bucket_edges: Optional[Sequence[int]] = None,
                 validate_payloads: bool = True,
                 wal=None, max_retries: int = 2,
                 backoff_base: float = 0.05,
                 retry_deadline: Optional[float] = None,
                 wal_truncate_every: int = 16):
        if depth < 1 or window < 1:
            raise ValueError("depth and window must be >= 1")
        if max_retries < 0 or backoff_base < 0:
            raise ValueError("max_retries and backoff_base must be >= 0")
        self.service = service
        self.window = int(window)
        self.bucket_edges = (None if bucket_edges is None
                             else tuple(sorted(int(e) for e in bucket_edges)))
        self.validate_payloads = validate_payloads
        self.wal = wal
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.retry_deadline = retry_deadline
        self.wal_truncate_every = max(1, int(wal_truncate_every))
        # published metrics (process-global registry, repro_torch.obs)
        m = obs_metrics.get_metrics()
        self._m_depth = m.gauge(
            "ingest_queue_depth", "requests waiting in the bounded queue")
        self._m_backpressure = m.counter(
            "ingest_backpressure_total",
            "submits that hit a full queue (queue.Full raised)")
        self._m_submitted = m.counter(
            "ingest_submitted_total", "accepted submits")
        self._m_rejected = m.counter(
            "ingest_rejected_total", "submits rejected at validation")
        self._m_applied = m.counter(
            "ingest_applied_total", "updates applied to the service")
        self._m_errors = m.counter(
            "ingest_errors_total", "per-request worker-side failures")
        self._m_retries = m.counter(
            "ingest_retries_total",
            "whole-round retries after a transient apply failure")
        self._m_quarantined = m.counter(
            "ingest_quarantined_total",
            "poison lanes excised from their cohort (error recorded, "
            "round survived)")
        self._m_latency = m.histogram(
            "ingest_drain_latency_seconds",
            "submit -> applied latency through the queue")
        self._q: "queue.Queue[Tuple]" = queue.Queue(maxsize=depth)
        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        self._inflight: Dict[int, int] = {}
        self._closed_sids: set = set()
        self._errors: List[Tuple[int, Exception]] = []
        self._lat: List[float] = []         # submit->applied seconds
        self._submitted = 0
        self._applied = 0
        self._rejected = 0
        self._rounds = 0
        self._round_index = 0               # monotone, fault-point context
        self._retries = 0
        self._quarantined = 0
        self._real_rows = 0
        self._padded_rows = 0
        self._batches = 0
        # WAL bookkeeping: resolved-but-not-yet-contiguous seqnos
        self._wal_done: Set[int] = set()
        self._gate = threading.Event()      # test hook: hold() stalls drain
        self._gate.set()
        self._stop = False
        self._death: Optional[str] = None   # worker traceback after a crash
        self._heartbeat = time.monotonic()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="sketch-ingest")
        self._worker.start()

    # -- failure detection ---------------------------------------------------

    @property
    def worker_alive(self) -> bool:
        return self._worker.is_alive()

    def heartbeat_age(self) -> float:
        """Seconds since the worker last reported progress (liveness
        signal for external watchdogs; grows unboundedly after a death)."""
        return time.monotonic() - self._heartbeat

    def _check_worker(self) -> None:
        """Fail fast when the worker died unexpectedly: nobody will ever
        drain the queue, so blocking would hang the caller forever."""
        if self._death is not None or (not self._worker.is_alive()
                                       and not self._stop):
            raise WorkerDied("ingest worker thread died unexpectedly "
                             "(queue will never drain; accepted updates "
                             "are recoverable from the WAL — see "
                             "repro_torch.stream.wal.replay)",
                             self._death or "")

    # -- producer side -----------------------------------------------------

    def submit(self, sid: int, H, row0: int = 0,
               timeout: Optional[float] = None) -> Optional[int]:
        """Enqueue one update.  Blocks while the queue is full
        (backpressure); raises ``queue.Full`` only if ``timeout`` expires.
        Non-finite payloads raise ValueError HERE — before the request can
        ever reach the service's (Y, W) accumulators.  With a WAL
        attached, the update is journaled (fsynced — durable) before it is
        enqueued, and the journal seqno is returned."""
        if self._stop:
            raise RuntimeError("ingest queue is shut down")
        self._check_worker()
        H = np.asarray(H)
        row0 = int(row0)
        if self.service.mesh is not None and row0 != 0:
            # grid streams take full-shape additive updates only: refuse
            # here rather than apply the slab at row 0
            with self._lock:
                self._rejected += 1
            self._m_rejected.inc()
            raise ValueError(
                f"stream {sid}: distributed streams take full-shape "
                f"additive updates only (row0 must be 0, got {row0})")
        if self.validate_payloads and not np.all(np.isfinite(
                H.astype(np.float32, copy=False))):
            with self._lock:
                self._rejected += 1
            self._m_rejected.inc()
            raise ValueError(
                f"non-finite update payload for stream {sid} rejected at "
                f"submit (accumulators untouched)")
        with self._lock:
            if sid in self._closed_sids:
                raise ValueError(f"stream {sid} was closed via this queue")
            self._inflight[sid] = self._inflight.get(sid, 0) + 1
            self._submitted += 1
        # parent span id captured on the SUBMITTING thread: the worker's
        # apply span re-parents under it across the thread boundary
        parent = obs_trace.current_span_id()
        seq = None
        try:
            if self.wal is not None:
                # journal-before-enqueue: once submit returns, the update
                # is durable.  A crash between the fsync here and the
                # round landing is exactly what wal.replay recovers.
                seq = self.wal.append(sid, row0, H)
            item = (sid, H, row0, time.perf_counter(), parent, seq)
            # bounded put as a loop of short-timeout puts, re-checking
            # worker liveness between attempts: a worker that dies while
            # the queue is full can never drain it, and its death cannot
            # wake a blocked ``queue.Queue.put`` — a single indefinitely
            # blocking put would hang the producer forever
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            while True:
                self._check_worker()
                step = (0.05 if deadline is None else
                        min(0.05, max(0.0, deadline - time.monotonic())))
                try:
                    self._q.put(item, timeout=step)
                    break
                except queue.Full:
                    if deadline is not None and time.monotonic() >= deadline:
                        raise
        except (queue.Full, WorkerDied) as e:
            with self._lock:
                self._inflight[sid] -= 1
                self._submitted -= 1
                if seq is not None:
                    # journaled but never accepted: resolve the seqno so
                    # the watermark keeps moving (the caller saw the
                    # rejection; semantics of a timed-out submit are
                    # "maybe applied" across a crash, as for any timeout)
                    self._wal_resolve([seq])
                self._done.notify_all()
            if isinstance(e, queue.Full):
                self._m_backpressure.inc()
            raise
        self._m_submitted.inc()
        self._m_depth.set(self._q.qsize())
        return seq

    # -- worker side -------------------------------------------------------

    def _drain(self) -> List[Tuple]:
        if not self._gate.is_set():         # held: park without consuming
            return []
        try:
            first = self._q.get(timeout=0.02)
        except queue.Empty:
            return []
        batch = [first]
        while len(batch) < self.window:
            try:
                batch.append(self._q.get_nowait())
            except queue.Empty:
                break
        return batch

    def _run(self) -> None:
        try:
            while True:
                self._heartbeat = time.monotonic()
                self._gate.wait()
                if self._stop and self._q.empty():
                    return
                batch = self._drain()
                if not batch:
                    if self._stop:
                        return
                    continue
                for rnd in self._rounds_of(batch):
                    self._apply(rnd)
                self._batches += 1
                if (self.wal is not None
                        and self._batches % self.wal_truncate_every == 0):
                    self.wal.truncate()
        except BaseException:   # a real crash (incl. chaos WorkerKilled):
            # record the corpse's traceback and wake every waiter so
            # submit/flush/close_stream fail fast instead of hanging
            self._death = traceback.format_exc()
            with self._lock:
                self._done.notify_all()

    def _rounds_of(self, batch: List[Tuple]) -> List[List[Tuple]]:
        """Split a drained window into rounds of at most one request a
        stream.  Local mode: the i-th request of a stream lands in round
        i, so per-stream FIFO order survives the fusion.  Grid mode: runs
        of consecutive requests, so the rounds apply in submit order."""
        rounds: List[List[Tuple]] = []
        if self.service.mesh is not None:
            for req in batch:
                if not rounds or any(r[0] == req[0] for r in rounds[-1]):
                    rounds.append([])
                rounds[-1].append(req)
            return rounds
        seen: Dict[int, int] = {}
        for req in batch:
            i = seen.get(req[0], 0)
            seen[req[0]] = i + 1
            if i == len(rounds):
                rounds.append([])
            rounds[i].append(req)
        return rounds

    def _dispatch(self, pending: List[Tuple[int, Any, int]]) -> None:
        """One round's service dispatch: one fused ``update_ragged``
        (local mode) or one ``service.update`` a lane, in order (grid
        mode).  ``pending`` is consumed in place, a lane removed once it
        has landed, so a failure leaves exactly the lanes not yet applied
        for the retry and the fallback.  A local round is all or nothing
        (``update_ragged`` validates every lane before it mutates any
        stream)."""
        if self.service.mesh is None:
            self.service.update_ragged(list(pending),
                                       bucket_edges=self.bucket_edges)
            pending.clear()
            return
        while pending:
            sid, H, _ = pending[0]
            faults.fire("ingest.dispatch_lane", sid=sid)
            self.service.update(sid, H)
            pending.pop(0)

    def _apply(self, rnd: List[Tuple]) -> None:
        items = [(sid, H, row0) for sid, H, row0, _, _, _ in rnd]
        # parent under the earliest submitter's span (cross-thread): the
        # timeline shows which request pulled this fused round in
        parent = next((p for *_, p, _ in rnd if p is not None), None)
        self._round_index += 1
        round_index = self._round_index
        err = None
        attempt = 0
        t_start = time.monotonic()
        pending = list(items)       # lanes not yet applied (exactly once)
        while True:
            try:
                # chaos hook: WorkerKilled here simulates the worker dying
                # mid-round (BaseException — escapes this handler and
                # kills the thread); a transient exc exercises retry
                faults.fire("ingest.apply_round", round_index=round_index,
                            lanes=len(items))
                with obs_trace.span("ingest.apply_round", cat="ingest",
                                    parent=parent, lanes=len(items),
                                    attempt=attempt):
                    self._dispatch(pending)
                err = None
                break
            except KernelLaunchError:     # the card refused: not transient
                raise
            except Exception as e:        # transient? retry with backoff
                err = e
                budget_left = (self.retry_deadline is None
                               or time.monotonic() - t_start
                               < self.retry_deadline)
                if attempt >= self.max_retries or not budget_left:
                    break
                attempt += 1
                with self._lock:
                    self._retries += 1
                self._m_retries.inc()
                time.sleep(self.backoff_base * (2.0 ** (attempt - 1)))
        lane_err: Dict[int, Exception] = {}
        if err is not None:
            # poison excision: the round failed even after retries — fall
            # back to per-lane application so one bad tenant cannot kill
            # its cohort.  Only the lanes not yet applied are tried: a
            # grid round keeps the lanes that landed, and a failed fused
            # round left no partial state behind (validate-then-mutate),
            # so every lane applies once.
            grid = self.service.mesh is not None
            for sid, H, row0 in pending:
                try:
                    faults.fire("ingest.apply_lane", sid=sid)
                    with obs_trace.span("ingest.apply_lane", cat="ingest",
                                        parent=parent, sid=sid):
                        if grid:
                            self.service.update(sid, H)
                        else:
                            self.service.update(sid, H, row0=row0)
                except KernelLaunchError:
                    raise
                except Exception as e2:
                    lane_err[sid] = e2
                    with self._lock:
                        self._quarantined += 1
                    self._m_quarantined.inc()
        # a round counts as applied once its kernels have finished on the
        # card, so latency is submit -> landed (a device fault raises here
        # and kills the worker: submit/flush then raise WorkerDied)
        self.service.sync()
        now = time.perf_counter()
        resolved: List[int] = []
        with self._lock:
            self._rounds += 1
            for sid, H, _, t0, _, seq in rnd:
                self._inflight[sid] -= 1
                failed = err is not None and sid in lane_err
                if not failed:
                    self._applied += 1
                    self._lat.append(now - t0)
                    self._m_applied.inc()
                    self._m_latency.observe(now - t0)
                    k = H.shape[0]
                    self._real_rows += k
                    if self.service.mesh is None:
                        kb = snap_bucket(k, self.bucket_edges)
                        self._padded_rows += max(kb, k) - k
                else:
                    self._errors.append((sid, lane_err[sid]))
                    self._m_errors.inc()
                if seq is not None:
                    # a quarantined lane resolves its seqno too: its error
                    # is recorded and surfaced — replay must not silently
                    # re-fail it forever
                    resolved.append(seq)
            if resolved:
                self._wal_resolve(resolved)
            if len(self._lat) > 8192:
                del self._lat[:4096]
            self._done.notify_all()
        self._m_depth.set(self._q.qsize())

    def _wal_resolve(self, seqnos: Sequence[int]) -> None:
        """Advance the WAL's applied watermark over the contiguous prefix
        of resolved seqnos (callers hold ``self._lock`` or are
        single-threaded with respect to it)."""
        self._wal_done.update(seqnos)
        w = self.wal.watermark
        while w + 1 in self._wal_done:
            w += 1
            self._wal_done.discard(w)
        self.wal.mark_applied(w)

    # -- control plane -----------------------------------------------------

    def hold(self) -> None:
        """Test hook: stall the worker (queue keeps filling — lets tests
        exercise backpressure deterministically)."""
        self._gate.clear()

    def release(self) -> None:
        self._gate.set()

    def flush(self, raise_errors: bool = False,
              timeout: Optional[float] = None) -> int:
        """Block until every accepted update has been applied (or failed).
        Raises :class:`WorkerDied` (not TimeoutError-after-forever) if the
        worker crashed.  Returns the lifetime applied count."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._done:
            while any(v for v in self._inflight.values()):
                self._check_worker()
                left = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                if left == 0.0 or not self._done.wait(
                        timeout=min(left or 1.0, 1.0)):
                    if deadline is not None and time.monotonic() >= deadline:
                        raise TimeoutError("flush timed out")
            self._check_worker()
            if raise_errors and self._errors:
                sid, err = self._errors[0]
                raise RuntimeError(
                    f"{len(self._errors)} ingest failure(s); first: "
                    f"stream {sid}: {err!r}") from err
            return self._applied

    def close_stream(self, sid: int, timeout: Optional[float] = None):
        """Drain the stream's in-flight updates, then close it on the
        service — every update accepted before this call lands in the
        returned (Y, W)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._done:
            self._closed_sids.add(sid)   # no new submits for this sid
            while self._inflight.get(sid, 0) > 0:
                self._check_worker()
                left = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                if left == 0.0 or not self._done.wait(
                        timeout=min(left or 1.0, 1.0)):
                    if deadline is not None and time.monotonic() >= deadline:
                        raise TimeoutError(
                            f"close_stream({sid}) timed out draining")
        return self.service.close(sid)

    def shutdown(self, wait: bool = True) -> None:
        """Stop accepting work; drain what was accepted, then stop the
        worker.  Idempotent — including after a worker crash (joining a
        corpse is a no-op; the WAL keeps the unapplied tail)."""
        self._stop = True
        self._gate.set()
        if wait and self._worker.is_alive():
            self._worker.join(timeout=30.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- introspection -----------------------------------------------------

    def stats(self, reset: bool = False) -> Dict[str, Any]:
        """Queue statistics.  ``reset=True`` additionally clears the
        WINDOW stats — the latency window and the real/padded row tallies
        behind ``pad_waste`` — after snapshotting, so a sustained-serving
        dashboard polling ``stats(reset=True)`` sees per-interval figures
        instead of an aggregate over the process lifetime.  The lifetime
        counters (submitted/applied/rejected/errors/rounds) are never
        reset."""
        with self._lock:
            lat = list(self._lat)
            real, padded = self._real_rows, self._padded_rows
            out = {
                "submitted": self._submitted,
                "applied": self._applied,
                "rejected": self._rejected,
                "errors": len(self._errors),
                "inflight": sum(self._inflight.values()),
                "rounds": self._rounds,
                "retries": self._retries,
                "quarantined": self._quarantined,
                "worker_alive": self._worker.is_alive(),
                "heartbeat_age_s": self.heartbeat_age(),
                "wal_depth": 0 if self.wal is None else self.wal.depth,
                "latency_p50_s": _percentile(lat, 50),
                "latency_p99_s": _percentile(lat, 99),
                "real_rows": real,
                "padded_rows": padded,
                "pad_waste": padded / max(1, real + padded),
            }
            if reset:
                self._lat.clear()
                self._real_rows = 0
                self._padded_rows = 0
            return out
