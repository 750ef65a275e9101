"""Chaos harness: a process-wide fault-point registry and the four
recovery drills (the port of the reference's ``stream/faults.py``).

Every failure the recovery layer claims to survive is injectable through
named fault points on the hot paths:

  ``ingest.apply_round``   — fired by ``IngestQueue._apply`` before the
                             dispatch of each round.  Arm with
                             ``exc=WorkerKilled`` to simulate the worker
                             thread dying mid-round, or with a transient
                             exception to exercise retry/backoff.
  ``ingest.apply_lane``    — fired per lane inside the poison-excision
                             fallback; arm with ``match={"sid": s}`` to
                             poison exactly one tenant.
  ``ingest.dispatch_lane`` — fired per lane inside a grid service's
                             one-lane-at-a-time dispatch, before the
                             lane's update; arm with ``match={"sid": s}``
                             to fail a round partway through (the lanes
                             that landed must not apply again).
  ``ckpt.pre_commit``      — fired by ``checkpoint.ckpt`` between staging
                             a step and publishing it; arm with a
                             ``handler`` that tears the staged files
                             (a torn write) or an ``exc`` (a crash before
                             the commit).
  ``elastic.reshard``      — fired by ``stream.elastic.reshard_stream``
                             and ``SketchService.reshard`` before any
                             block moves (a lost device).

Fault points are zero-cost when disarmed: ``fire`` is a dict lookup
returning immediately.  Arming is per point with an optional budget
(``times``) and an optional context ``match``.

The drills (:func:`run_chaos_scenario`, ``launch/serve.py --chaos``):
kill-worker (WAL replay, bitwise), torn-write (the torn step quarantined,
the good one restored bitwise), shrink-restore (a live stream on four
gloo ranks resharded (4,1,1) -> (2,1,1) -> (4,1,1), bitwise; the
reference runs 8 fake XLA devices) and eviction-storm (a budget of one
resident stream spilling to disk, bitwise).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

import torch

_ARMED: Dict[str, "_Fault"] = {}
_LOCK = threading.Lock()


class FaultInjected(RuntimeError):
    """Default exception raised by an armed fault point."""


class WorkerKilled(BaseException):
    """Simulated hard crash of a worker thread.  Deliberately a
    BaseException: it must escape the per-round ``except Exception``
    error-recording path the same way a real kill would — the worker
    dies, it does not log-and-continue."""


class _Fault:
    def __init__(self, exc=None, handler=None, times=None, match=None):
        self.exc = exc
        self.handler = handler
        self.times = times            # None = unlimited
        self.match = dict(match or {})
        self.fired = 0

    def applies(self, ctx: Dict[str, Any]) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        return all(ctx.get(k) == v for k, v in self.match.items())


def arm(point: str, *, exc: Optional[type] = None,
        handler: Optional[Callable] = None,
        times: Optional[int] = 1,
        match: Optional[Dict[str, Any]] = None) -> None:
    """Arm ``point``.  Exactly one of ``exc`` (raised at the point) or
    ``handler`` (called with the point's context kwargs) fires per
    matching ``fire``; ``times=None`` keeps the fault armed forever."""
    if exc is None and handler is None:
        exc = FaultInjected
    with _LOCK:
        _ARMED[point] = _Fault(exc=exc, handler=handler, times=times,
                               match=match)


def disarm(point: str) -> None:
    with _LOCK:
        _ARMED.pop(point, None)


def clear() -> None:
    """Disarm everything (test teardown)."""
    with _LOCK:
        _ARMED.clear()


def armed(point: str) -> bool:
    return point in _ARMED


def fire(point: str, **ctx) -> None:
    """Hot-path hook: no-op unless ``point`` is armed and the context
    matches.  An armed ``exc`` is raised here; an armed ``handler`` runs
    here (exceptions it raises propagate)."""
    fault = _ARMED.get(point)
    if fault is None or not fault.applies(ctx):
        return
    fault.fired += 1
    if fault.handler is not None:
        fault.handler(**ctx)
        return
    raise fault.exc(f"chaos: fault injected at {point!r} ({ctx})")


def fire_count(point: str) -> int:
    fault = _ARMED.get(point)
    return 0 if fault is None else fault.fired


# ---------------------------------------------------------------------------
# The recovery drills (launch/serve.py --chaos)
# ---------------------------------------------------------------------------

SCENARIOS = ("kill-worker", "torn-write", "shrink-restore", "eviction-storm")
RANKS_TIMEOUT_S = 300


def run_chaos_scenario(scenario: str, *, n1: int = 256, n2: int = 128,
                       r: int = 8, streams: int = 8, updates: int = 3,
                       workdir: Optional[str] = None,
                       verbose: bool = True, device=None) -> Dict[str, Any]:
    """Run one failure-and-recovery drill; returns a result dict whose
    ``recovered`` field is its verdict.

    Every drill builds its own small serving stack on ``device`` (None:
    the card), injects the fault through this registry, recovers through
    the production path (WAL replay, torn-checkpoint quarantine, live
    reshard, restore from disk) and checks the recovery bitwise against
    the run that never failed.  ``workdir`` (default: a temporary
    directory) holds the journal, checkpoints and spills.
    """
    import tempfile

    import numpy as np

    out: Dict[str, Any] = {"scenario": scenario}
    say = print if verbose else (lambda *a, **k: None)
    tmp_ctx = tempfile.TemporaryDirectory() if workdir is None else None
    workdir = workdir if workdir is not None else tmp_ctx.name
    rng = np.random.default_rng(0)
    try:
        if scenario == "kill-worker":
            out.update(_chaos_kill_worker(rng, n1, n2, r, streams, updates,
                                          workdir, say, device))
        elif scenario == "torn-write":
            out.update(_chaos_torn_write(rng, n1, n2, r, workdir, say,
                                         device))
        elif scenario == "shrink-restore":
            out.update(_chaos_shrink_restore(workdir, say, device))
        elif scenario == "eviction-storm":
            out.update(_chaos_eviction_storm(rng, n1, n2, r, streams,
                                             workdir, say, device))
        else:
            raise ValueError(f"unknown chaos scenario {scenario!r}; "
                             f"have {SCENARIOS}")
    finally:
        clear()
        if tmp_ctx is not None:
            tmp_ctx.cleanup()
    say(f"[chaos:{scenario}] recovered={out['recovered']}")
    return out


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same dtype, shape and bits (``-0.0`` differs from ``0.0``)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def _mk_traffic(rng, streams, updates, n1, n2):
    traffic = []
    for _ in range(updates):
        for s in range(streams):
            k = int(rng.integers(1, 33))
            traffic.append((s, rng.standard_normal((k, n2)).astype("float32"),
                            int(rng.integers(0, n1 - k + 1))))
    return traffic


def _chaos_kill_worker(rng, n1, n2, r, streams, updates, workdir, say,
                       device):
    """Kill the ingest worker mid-round; recover by replaying the WAL into
    a fresh service: bitwise the run that never crashed."""
    import os
    import time

    from . import wal as wal_mod
    from .ingest import IngestQueue, WorkerDied
    from .service import SketchService
    from .state import StreamConfig

    cfgs = [StreamConfig(n1=n1, n2=n2, r=r, seed=s, corange=False)
            for s in range(streams)]
    traffic = _mk_traffic(rng, streams, updates, n1, n2)

    ref = SketchService(device=device)          # the run that never crashes
    ref_sids = [ref.open(c) for c in cfgs]
    for s, H, row0 in traffic:
        ref.update(ref_sids[s], H, row0=row0)
    ref_Y = [ref.sketch(s) for s in ref_sids]

    svc = SketchService(device=device)          # journaled, then killed
    sids = [svc.open(c) for c in cfgs]
    wal = wal_mod.WriteAheadLog(os.path.join(workdir, "ingest.wal"))
    q = IngestQueue(svc, wal=wal, depth=max(256, len(traffic)))
    # each stream's i-th submit lands in a round of its own, so at least
    # ``updates`` rounds run and some have landed before the kill.  The
    # worker is held while the traffic is accepted (journaled), so that
    # the kill lands mid-stream however fast the rounds run; a submit the
    # dead worker refuses would be the client's to send again
    arm("ingest.apply_round", exc=WorkerKilled, times=None,
        match={"round_index": max(2, updates - 1)})
    q.hold()
    for s, H, row0 in traffic:
        q.submit(sids[s], H, row0)
    q.release()
    died = False
    try:
        q.flush()
    except WorkerDied:
        died = True
    say(f"[chaos] worker died={died}, wal depth={wal.depth}")
    disarm("ingest.apply_round")
    q.shutdown()
    wal.close()

    t0 = time.perf_counter()         # recovery: a fresh service, replayed
    svc2 = SketchService(device=device)
    sids2 = [svc2.open(c) for c in cfgs]
    nrec, words = wal_mod.replay(wal.path, svc2,
                                 sid_map=dict(zip(sids, sids2)))
    svc2.sync()
    dt = time.perf_counter() - t0
    bitwise = all(bits_equal(svc2.sketch(s), y)
                  for s, y in zip(sids2, ref_Y))
    say(f"[chaos] replayed {nrec} records / {words} words in "
        f"{dt * 1e3:.1f} ms, bitwise={bitwise}")
    return {"recovered": died and bitwise, "worker_died": died,
            "replayed_records": nrec, "replayed_words": words,
            "recover_s": dt, "bitwise": bitwise}


def _chaos_torn_write(rng, n1, n2, r, workdir, say, device):
    """Tear a checkpoint commit: the torn step is never restored, and the
    previous good step loads bitwise."""
    import os

    from repro_torch.checkpoint import ckpt

    from .state import StreamConfig, StreamingSketch

    d = os.path.join(workdir, "ckpt")
    st = StreamingSketch(StreamConfig(n1=n1, n2=n2, r=r, seed=3,
                                      corange=False), device=device)
    st.update_rows(0, rng.standard_normal((32, n2)).astype("float32"))
    st.save(d, step=1)
    good_Y = st.Y.clone()
    st.update_rows(32, rng.standard_normal((32, n2)).astype("float32"))

    def tear(tmp, **_):
        os.remove(os.path.join(tmp, "manifest.json"))

    arm("ckpt.pre_commit", handler=tear)
    st.save(d, step=2)
    disarm("ckpt.pre_commit")
    torn = ckpt.torn_steps(d)
    latest = ckpt.latest_step(d)
    st2 = StreamingSketch.restore(d, device=device)
    ok = torn == [2] and latest == 1 and bits_equal(st2.Y, good_Y)
    say(f"[chaos] torn steps={torn}, latest={latest}, "
        f"restored step-1 bitwise={ok}")
    return {"recovered": ok, "torn_steps": torn, "latest_step": latest}


def _shrink_rank(rank: int, world: int, device) -> bool:
    """One gloo rank of the shrink-restore drill: a live stream on
    (4,1,1) loses two ranks, streams on (2,1,1), gets them back; Y must be
    bitwise the stream that never moved."""
    import numpy as np

    from repro_torch.core.sketch import make_grid_groups

    from .distributed import ShardedStreamingSketch
    from .elastic import reshard_stream
    from .state import StreamConfig

    cfg = StreamConfig(n1=256, n2=256, r=8, seed=5, corange=False)
    rng = np.random.default_rng(0)
    slabs = [(i * 64, rng.standard_normal((64, 256)).astype("float32"))
             for i in range(4)]
    g = make_grid_groups(world, 1, 1)
    ref = ShardedStreamingSketch(cfg, g, device=device)
    for row0, H in slabs:
        ref.update_rows(row0, H)
    sk = ShardedStreamingSketch(cfg, g, device=device)
    for row0, H in slabs[:2]:
        sk.update_rows(row0, H)
    sk = reshard_stream(sk, (world // 2, 1, 1))     # device loss
    sk.update_rows(*slabs[2])                       # streaming goes on
    sk = reshard_stream(sk, (world, 1, 1))          # the ranks came back
    sk.update_rows(*slabs[3])
    return (sk.num_updates == ref.num_updates
            and bits_equal(sk.sketch, ref.sketch))


def _rank_entry(fn, rank, world, store, queue, args):
    import datetime
    import traceback

    import torch.distributed as dist
    try:
        device = args[0]
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=RANKS_TIMEOUT_S))
        try:
            queue.put((rank, fn(rank, world, *args), None))
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — reported to the parent
        queue.put((rank, None, traceback.format_exc()))


def spawn_ranks(fn, world: int, args, workdir: str) -> list:
    """``[fn(rank, world, *args) for rank in range(world)]``, each rank a
    spawned process of one gloo group meeting at a ``file://`` store
    under ``workdir`` (on the card, every rank on cuda:0: NCCL refuses two
    ranks on one card).  A failed rank, or a world that has not answered
    in ``RANKS_TIMEOUT_S``, raises; every process is joined or killed."""
    import multiprocessing as mp
    import os
    import shutil
    import tempfile

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="ranks_", dir=workdir)
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, store, queue, tuple(args)))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = [None] * world, []
    try:
        for _ in range(world):
            rank, res, err = queue.get(timeout=RANKS_TIMEOUT_S)
            if err:
                errors.append(f"rank {rank}:\n{err}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return results


def _chaos_shrink_restore(workdir, say, device):
    """Reshard a live stream on four gloo ranks onto two and back; Y must
    stay bitwise the stream that never moved."""
    res = spawn_ranks(_shrink_rank, 4, (device,), workdir)
    ok = all(res)
    say(f"[chaos] shrink/grow reshard (4,1,1) -> (2,1,1) -> (4,1,1) on "
        f"4 gloo ranks, bitwise={ok} (by rank: {res})")
    return {"recovered": ok}


def _chaos_eviction_storm(rng, n1, n2, r, streams, workdir, say, device):
    """Hammer a budget-1 service so that every touch spills the previous
    resident to disk: the state survives the storm bitwise."""
    import os
    import time

    from repro_torch.obs import metrics as obs_metrics

    from .service import SketchService
    from .state import StreamConfig

    cfgs = [StreamConfig(n1=n1, n2=n2, r=r, seed=s, corange=False)
            for s in range(streams)]
    spills = obs_metrics.get_metrics().counter("sketch_spills_total")
    ref = SketchService(device=device)
    svc = SketchService(max_resident=1, device=device,
                        spill_dir=os.path.join(workdir, "spill"))
    ref_sids = [ref.open(c) for c in cfgs]
    sids = [svc.open(c) for c in cfgs]
    spilled0 = spills.value()
    t0 = time.perf_counter()
    for _ in range(3):
        for i in range(streams):     # every update storms an eviction
            k = int(rng.integers(1, 33))
            H = rng.standard_normal((k, n2)).astype("float32")
            row0 = int(rng.integers(0, n1 - k + 1))
            ref.update(ref_sids[i], H, row0=row0)
            svc.update(sids[i], H, row0=row0)
    svc.sync()
    dt = time.perf_counter() - t0
    n = int(spills.value() - spilled0)
    ok = all(bits_equal(svc.sketch(s), ref.sketch(rs))
             for s, rs in zip(sids, ref_sids))
    say(f"[chaos] {svc.stats()['evicted']} evicted after the storm, "
        f"{n} spills in its {3 * streams} updates ({dt:.3f} s), "
        f"bitwise={ok}")
    return {"recovered": ok, "evicted": svc.stats()["evicted"],
            "spills": n, "storm_s": dt}
