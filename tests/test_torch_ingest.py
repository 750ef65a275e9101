"""repro_torch's ingest queue, write-ahead log and fault points, on the CPU.

The queue's rounds go through the service's fused ragged update; its
results are held bitwise to the same traffic applied stream by stream
through ``SketchService.update`` (the port's lane-vs-solo oracle).  The
journal's record format is the reference's, so a journal written by the
port is read back by ``repro.stream.wal.scan`` too.  Every wait has a
timeout, so a hang fails instead of stalling the run.
"""
import queue as pyqueue
import threading
import time

import numpy as np
import pytest
import torch

from repro.stream import wal as jwal
from repro_torch.kernels.sketch_matmul import KernelLaunchError
from repro_torch.stream import faults
from repro_torch.stream import wal as wal_mod
from repro_torch.stream.ingest import IngestQueue, WorkerDied
from repro_torch.stream.service import SketchService
from repro_torch.stream.state import StreamConfig

T = 60.0     # seconds any single wait may take before the test fails


@pytest.fixture(autouse=True)
def _clean_faults():
    """The fault registry is process-global: every test starts and ends
    with nothing armed."""
    faults.clear()
    yield
    faults.clear()


def _svc():
    return SketchService(device="cpu")


def _cfgs(n, n1=48, n2=32, r=4, corange=True):
    return [StreamConfig(n1=n1, n2=n2, r=r, seed=1000 + s, corange=corange)
            for s in range(n)]


def _traffic(rng, streams, updates, n1, n2, max_k=12):
    """updates-per-stream row-block traffic, per-stream FIFO order."""
    out = []
    for _ in range(updates):
        for s in range(streams):
            k = int(rng.integers(1, max_k + 1))
            out.append((s, rng.standard_normal((k, n2)).astype(np.float32),
                        int(rng.integers(0, n1 - k + 1))))
    return out


def _solo(cfgs, traffic):
    """The same traffic, stream by stream, in order: (Y, W) per stream."""
    ref = _svc()
    sids = [ref.open(c) for c in cfgs]
    for s, H, row0 in traffic:
        ref.update(sids[s], H, row0=row0)
    return [(ref.sketch(s), ref.corange(s)) for s in sids]


def _assert_state(svc, sids, want):
    for sid, (Y, W) in zip(sids, want):
        assert torch.equal(svc.sketch(sid).view(torch.int32),
                           Y.view(torch.int32))
        if W is not None:
            assert torch.equal(svc.corange(sid).view(torch.int32),
                               W.view(torch.int32))


def _wait(pred, what):
    deadline = time.monotonic() + T
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def test_queue_bitwise_and_per_stream_order():
    rng = np.random.default_rng(3)
    cfgs = _cfgs(3)
    traffic = _traffic(rng, 3, 3, 48, 32)     # order within a stream matters
    want = _solo(cfgs, traffic)
    svc = _svc()
    sids = [svc.open(c) for c in cfgs]
    with IngestQueue(svc, depth=32, window=8) as q:
        for s, H, row0 in traffic:
            q.submit(sids[s], H, row0, timeout=T)
        assert q.flush(raise_errors=True, timeout=T) == 9
        st = q.stats()
    assert st["applied"] == 9 and st["errors"] == 0 and st["rounds"] >= 3
    assert st["real_rows"] == sum(H.shape[0] for _, H, _ in traffic)
    _assert_state(svc, sids, want)


def test_queue_full_applies_backpressure_not_drops():
    svc = _svc()
    sid = svc.open(_cfgs(1)[0])
    H = np.ones((2, 32), np.float32)
    q = IngestQueue(svc, depth=4, window=8)
    try:
        q.submit(sid, H, 0, timeout=T)
        q.flush(timeout=T)
        q.hold()                      # stall the worker deterministically
        time.sleep(0.1)               # let its in-flight get() time out
        for _ in range(4):
            q.submit(sid, H, 0, timeout=T)
        with pytest.raises(pyqueue.Full):
            q.submit(sid, H, 0, timeout=0.2)
        q.release()
        q.flush(raise_errors=True, timeout=T)
        assert q.stats()["applied"] == 5, "held updates must not be dropped"
    finally:
        q.shutdown()


def test_queue_rejects_nonfinite_before_touching_state():
    svc = _svc()
    sid = svc.open(_cfgs(1)[0])
    with IngestQueue(svc, depth=8, window=4) as q:
        q.submit(sid, np.ones((2, 32), np.float32), 0, timeout=T)
        q.flush(raise_errors=True, timeout=T)
        before = svc.sketch(sid).clone()
        for bad in (np.nan, np.inf, -np.inf):
            with pytest.raises(ValueError, match="non-finite"):
                q.submit(sid, np.full((2, 32), bad, np.float32), 0)
        q.flush(raise_errors=True, timeout=T)
        assert torch.equal(svc.sketch(sid), before)
        st = q.stats()
    assert st["rejected"] == 3 and st["applied"] == 1


def test_queue_worker_errors_are_surfaced_not_swallowed():
    svc = _svc()
    sid = svc.open(_cfgs(1)[0])
    with IngestQueue(svc, depth=8, window=4, validate_payloads=False,
                     backoff_base=0.0) as q:
        svc.close(sid)                # race: sid dies under the queue
        q.submit(sid, np.ones((2, 32), np.float32), 0, timeout=T)
        with pytest.raises(RuntimeError, match="ingest failure"):
            q.flush(raise_errors=True, timeout=T)
        assert q.stats()["errors"] == 1


def test_close_stream_with_inflight_work_drains_first():
    rng = np.random.default_rng(5)
    cfg = _cfgs(1)[0]
    traffic = [(0, rng.standard_normal((k, 32)).astype(np.float32), 8 * j)
               for j, k in enumerate([3, 7, 1, 5, 8])]
    (Yw, Ww), = _solo([cfg], traffic)
    svc = _svc()
    sid = svc.open(cfg)
    q = IngestQueue(svc, depth=64, window=8)
    try:
        q.hold()
        time.sleep(0.1)
        for _, H, row0 in traffic:
            q.submit(sid, H, row0, timeout=T)
        q.release()
        Y, W = q.close_stream(sid, timeout=T)      # drains all 5 first
        assert torch.equal(Y, Yw) and torch.equal(W, Ww)
        with pytest.raises(ValueError, match="closed"):
            q.submit(sid, np.ones((2, 32), np.float32), 0)
        assert q.stats()["errors"] == 0
    finally:
        q.shutdown()


def test_transient_round_failure_retried_then_lands():
    rng = np.random.default_rng(4)
    cfgs = _cfgs(2, corange=False)
    traffic = _traffic(rng, 2, 2, 48, 32)
    want = _solo(cfgs, traffic)
    svc = _svc()
    sids = [svc.open(c) for c in cfgs]
    faults.arm("ingest.apply_round", exc=faults.FaultInjected, times=1)
    with IngestQueue(svc, max_retries=2, backoff_base=0.0) as q:
        for s, H, row0 in traffic:
            q.submit(sids[s], H, row0, timeout=T)
        q.flush(raise_errors=True, timeout=T)     # the retry absorbed it
        st = q.stats()
    assert st["retries"] == 1 and st["errors"] == 0
    assert st["quarantined"] == 0 and st["applied"] == len(traffic)
    assert faults.fire_count("ingest.apply_round") == 1
    _assert_state(svc, sids, want)


def test_poison_lane_quarantined_cohort_survives():
    rng = np.random.default_rng(5)
    cfgs = _cfgs(3)
    traffic = _traffic(rng, 3, 2, 48, 32)
    want = _solo(cfgs, traffic)
    svc = _svc()
    sids = [svc.open(c) for c in cfgs]
    bad = sids[1]
    # every fused round fails -> per-lane fallback; one tenant is poison
    faults.arm("ingest.apply_round", exc=faults.FaultInjected, times=None)
    faults.arm("ingest.apply_lane", exc=faults.FaultInjected, times=None,
               match={"sid": bad})
    with IngestQueue(svc, max_retries=1, backoff_base=0.0) as q:
        for s, H, row0 in traffic:
            q.submit(sids[s], H, row0, timeout=T)
        applied = q.flush(timeout=T)
        st = q.stats()
        with pytest.raises(RuntimeError, match="ingest failure"):
            q.flush(raise_errors=True, timeout=T)
    assert applied == 4 and st["quarantined"] == 2 and st["errors"] == 2
    assert st["retries"] == st["rounds"]          # one per round
    _assert_state(svc, [sids[0], sids[2]], [want[0], want[2]])
    # the poison lane never touched its accumulators
    assert not svc.sketch(bad).any() and not svc.corange(bad).any()


@pytest.mark.parametrize("point", ["ingest.apply_round", "ingest.apply_lane"])
def test_kernel_launch_error_is_neither_retried_nor_quarantined(point):
    """A launch the card refused kills the worker: no retry, no per-lane
    re-application (which would hide a failed fold behind the solo path)."""
    svc = _svc()
    sid = svc.open(_cfgs(1)[0])
    if point == "ingest.apply_lane":     # reach the per-lane path first
        faults.arm("ingest.apply_round", exc=faults.FaultInjected,
                   times=None)
    faults.arm(point, exc=KernelLaunchError, times=None)
    q = IngestQueue(svc, max_retries=2, backoff_base=0.0)
    try:
        q.submit(sid, np.ones((4, 32), np.float32), 0, timeout=T)
        with pytest.raises(WorkerDied) as ei:
            q.flush(raise_errors=True, timeout=T)
        assert "KernelLaunchError" in ei.value.traceback_text
        st = q.stats()
        assert st["quarantined"] == 0 and st["applied"] == 0
        assert st["retries"] == (2 if point == "ingest.apply_lane" else 0)
        assert faults.fire_count(point) == 1
    finally:
        q.shutdown()


def test_worker_death_fails_fast_and_shutdown_is_idempotent():
    svc = _svc()
    sid = svc.open(_cfgs(1)[0])
    H = np.ones((4, 32), np.float32)
    faults.arm("ingest.apply_round", exc=faults.WorkerKilled, times=None)
    q = IngestQueue(svc)
    q.submit(sid, H, 0, timeout=T)
    _wait(lambda: not q.worker_alive, "the worker to die")
    with pytest.raises(WorkerDied) as ei:
        q.submit(sid, H, 0)
    assert "WorkerKilled" in ei.value.traceback_text
    with pytest.raises(WorkerDied):
        q.flush(timeout=T)
    with pytest.raises(WorkerDied):
        q.close_stream(sid, timeout=T)
    assert q.stats()["worker_alive"] is False
    q.shutdown()
    q.shutdown()                      # joining a corpse is a no-op


def test_blocked_submit_fails_fast_on_worker_death():
    svc = _svc()
    sid = svc.open(_cfgs(1)[0])
    H = np.ones((4, 32), np.float32)
    entered, block = threading.Event(), threading.Event()

    def killer(**ctx):
        entered.set()
        block.wait(timeout=T)
        raise faults.WorkerKilled("the worker dies with the queue full")

    faults.arm("ingest.apply_round", handler=killer, times=None)
    q = IngestQueue(svc, depth=1)
    q.submit(sid, H, 0, timeout=T)       # worker takes it, parks in killer
    assert entered.wait(T)
    q.submit(sid, H, 0, timeout=T)       # refills the depth-1 queue
    result = {}

    def blocked_submit():
        try:
            q.submit(sid, H, 0)          # full queue: blocks
            result["exc"] = None
        except BaseException as e:
            result["exc"] = e

    t = threading.Thread(target=blocked_submit)
    t.start()
    time.sleep(0.2)
    assert t.is_alive()                  # genuinely blocked
    block.set()                          # the worker now dies mid-round
    t.join(T)
    assert not t.is_alive()
    assert isinstance(result["exc"], WorkerDied)
    q.shutdown()


def test_wal_replay_onto_fresh_service_bitwise(tmp_path):
    """Every accepted submit is journaled; replaying the journal onto a
    fresh service (solo updates) gives the queue's fused-round state
    bitwise, and the reference's scanner reads the port's journal."""
    rng = np.random.default_rng(1)
    cfgs = _cfgs(3)
    traffic = _traffic(rng, 3, 3, 48, 32)
    svc = _svc()
    sids = [svc.open(c) for c in cfgs]
    wal = wal_mod.WriteAheadLog(str(tmp_path / "ingest.wal"))
    with IngestQueue(svc, wal=wal, wal_truncate_every=1000) as q:
        seqs = [q.submit(sids[s], H, row0, timeout=T)
                for s, H, row0 in traffic]
        q.flush(raise_errors=True, timeout=T)
    assert seqs == list(range(1, len(traffic) + 1))
    assert wal.watermark == len(traffic) and wal.depth == 0
    wal.close()
    records, torn = jwal.scan(wal.path)
    assert torn is None and len(records) == len(traffic)
    svc2 = _svc()
    sids2 = [svc2.open(c) for c in cfgs]
    nrec, words = wal_mod.replay(wal.path, svc2,
                                 sid_map=dict(zip(sids, sids2)))
    assert nrec == len(traffic)
    assert words == sum(H.size for _, H, _ in traffic)
    _assert_state(svc2, sids2, [(svc.sketch(s), svc.corange(s))
                                for s in sids])


def test_kill_worker_mid_round_then_replay_bitwise(tmp_path):
    rng = np.random.default_rng(2)
    cfgs = _cfgs(3, corange=False)
    traffic = _traffic(rng, 3, 3, 48, 32)
    svc = _svc()
    sids = [svc.open(c) for c in cfgs]
    wal = wal_mod.WriteAheadLog(str(tmp_path / "ingest.wal"))
    q = IngestQueue(svc, wal=wal)
    faults.arm("ingest.apply_round", exc=faults.WorkerKilled, times=None,
               match={"round_index": 2})
    died = False
    for s, H, row0 in traffic:
        try:
            q.submit(sids[s], H, row0, timeout=T)
        except WorkerDied:
            died = True
            break
    if not died:
        with pytest.raises(WorkerDied):
            q.flush(timeout=T)
    assert wal.depth > 0              # a journaled-but-unapplied tail
    q.shutdown()
    wal.close()
    # the journal holds the accepted prefix of the traffic, in order
    journaled = len(wal_mod.scan(wal.path)[0])
    assert journaled >= 2              # round 2 ran, so 2 were accepted
    svc2 = _svc()
    sids2 = [svc2.open(c) for c in cfgs]
    nrec, _ = wal_mod.replay(wal.path, svc2, sid_map=dict(zip(sids, sids2)))
    assert nrec == journaled
    _assert_state(svc2, sids2, _solo(cfgs, traffic[:journaled]))


def test_wal_torn_tail_discarded_and_watermark_skip(tmp_path):
    path = str(tmp_path / "w.wal")
    rng = np.random.default_rng(6)
    Hs = [rng.standard_normal((3, 8)).astype(np.float32) for _ in range(3)]
    with wal_mod.WriteAheadLog(path) as w:
        for i, H in enumerate(Hs):
            w.append(0, i, H)
    with open(path, "ab") as f:
        f.write(b"SWAL\x00\x00")              # a record cut by a crash
    recs, torn = wal_mod.scan(path)
    assert len(recs) == 3 and torn is not None
    assert all(np.array_equal(r.H, H) for r, H in zip(recs, Hs))
    with wal_mod.WriteAheadLog(path) as w:    # reopening repairs the tail
        assert wal_mod.scan(path)[1] is None
        assert w.append(0, 5, Hs[0]) == 4     # seqnos resume
    cfg = StreamConfig(n1=16, n2=8, r=2, seed=3)
    svc = _svc()
    sid = svc.open(cfg)
    nrec, _ = wal_mod.replay(path, svc, sid_map={0: sid}, watermark=2)
    assert nrec == 2 and svc.stats()["updates"] == 2
