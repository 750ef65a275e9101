"""repro_torch's recovery layer on the CPU, in one process: torn
checkpoints, the service's spill to disk, the grid-mode ingest queue and
WAL replay, the recovery arc and its metrics and spans, the chaos drills
and their launcher, and the reshard word functions.

Against the reference: the torn-step lists of ``repro.checkpoint.ckpt``
for the same saves and tears; ``repro.stream.SketchService`` at the f32
tolerance of ``tests/test_torch_service.py`` (``rtol=1e-5``,
``atol=1e-5·max|ref|``); ``repro.plan.model``'s reshard words exactly.
The grid-mode cases run on a (1,1,1) grid of a gloo world of one, as the
reference's own grid-mode cases run on a (1,1,1) mesh; the four-rank
reshard is ``tests/test_torch_elastic.py``.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import stream as jstream
from repro.checkpoint import ckpt as jckpt
from repro.plan import model as jmodel
from repro.stream import faults as jfaults
from repro_torch.checkpoint import ckpt
from repro_torch.core.sketch import make_grid_groups
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.plan import model as tmodel
from repro_torch.stream import IngestQueue, SketchService, StreamConfig
from repro_torch.stream import faults
from repro_torch.stream import wal as wal_mod
from repro_torch.stream.elastic import drain_reshard_resume
from repro_torch.stream.faults import bits_equal

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_faults():
    """Both fault registries are process-global."""
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """A (1,1,1) grid of a gloo world of one, for grid-mode services."""
    import torch.distributed as dist
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        yield make_grid_groups(1, 1, 1)
    finally:
        dist.destroy_process_group()


@pytest.fixture
def registry():
    prev = obs_metrics.set_metrics(None)
    try:
        yield obs_metrics.get_metrics()
    finally:
        obs_metrics.set_metrics(prev)


def _cfg(seed, n1=32, n2=16, r=4, corange=False):
    return StreamConfig(n1=n1, n2=n2, r=r, seed=seed, corange=corange)


# ---------------------------------------------------------------------------
# torn checkpoints
# ---------------------------------------------------------------------------

DATA_FILE = {"port": "tensors.pt", "reference": "arrays.npz"}


def _tear(kind, system):
    def tear(tmp, **_):
        if kind == "manifest":
            os.remove(os.path.join(tmp, "manifest.json"))
        else:                                   # cut the data file short
            path = os.path.join(tmp, DATA_FILE[system])
            with open(path, "r+b") as f:
                f.truncate(os.path.getsize(path) // 2)
    return tear


@pytest.mark.parametrize("kind", ["manifest", "data"])
def test_torn_steps_are_the_references(tmp_path, kind):
    """Steps 1 and 4 good, 2 and 3 torn at the commit, in both systems:
    the same ``torn_steps``, ``latest_step`` and quarantine; an explicit
    restore of a torn step raises ``TornCheckpointError``."""
    w = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = {}
    for system, mod, reg in (("port", ckpt, faults),
                             ("reference", jckpt, jfaults)):
        d = str(tmp_path / system)

        def save(step):
            if system == "port":
                mod.save(d, step, {"w": torch.from_numpy(w + step)},
                         keep=5)
            else:
                mod.save(d, step, {"w": w + step}, keep=5)
        save(1)
        reg.arm("ckpt.pre_commit", handler=_tear(kind, system), times=None,
                match={"step": 2})
        save(2)
        reg.arm("ckpt.pre_commit", handler=_tear(kind, system), times=None,
                match={"step": 3})
        save(3)
        reg.clear()
        got = {"torn": mod.torn_steps(d), "latest": mod.latest_step(d)}
        with pytest.raises(mod.TornCheckpointError, match="torn"):
            if system == "port":
                mod.restore_tree(d, step=2)
            else:
                mod.restore(d, {"w": w}, step=2)
        if system == "port":
            with pytest.raises(mod.TornCheckpointError):
                mod.restore(d, None, step=3)     # a train state's restore
            tree, step, _ = mod.restore_tree(d)
            got["restored"] = (step, tree["w"].numpy())
        else:
            tree, step, _ = mod.restore(d, {"w": w})
            got["restored"] = (step, np.asarray(tree["w"]))
        got["quarantined"] = mod.quarantine_torn(d)
        got["after"] = (mod.torn_steps(d), mod.quarantine_torn(d),
                        sorted(os.listdir(d)))
        save(4)
        got["latest4"] = mod.latest_step(d)
        out[system] = got
    port, ref = out["port"], out["reference"]
    assert port["torn"] == ref["torn"] == [2, 3]
    assert port["latest"] == ref["latest"] == 1
    assert port["restored"][0] == ref["restored"][0] == 1
    np.testing.assert_array_equal(port["restored"][1], w + 1)
    np.testing.assert_array_equal(ref["restored"][1], w + 1)
    assert port["quarantined"] == ref["quarantined"] == [2, 3]
    assert port["after"] == ref["after"] == (
        [], [], ["step_00000001", "step_00000002.torn",
                 "step_00000003.torn"])
    assert port["latest4"] == ref["latest4"] == 4


def test_crash_before_commit_publishes_nothing(tmp_path):
    """A fault raised at ``ckpt.pre_commit`` publishes no step and leaves
    no staging directory, in both systems."""
    for system, mod, reg in (("port", ckpt, faults),
                             ("reference", jckpt, jfaults)):
        d = str(tmp_path / system)
        state = ({"w": torch.zeros(3)} if system == "port"
                 else {"w": np.zeros(3, np.float32)})
        mod.save(d, 1, state)
        reg.arm("ckpt.pre_commit", exc=reg.FaultInjected, match={"step": 2})
        with pytest.raises(reg.FaultInjected):
            mod.save(d, 2, state)
        reg.clear()
        assert mod.latest_step(d) == 1 and mod.torn_steps(d) == []
        assert sorted(os.listdir(d)) == ["step_00000001"], system


# ---------------------------------------------------------------------------
# spill to disk
# ---------------------------------------------------------------------------

def test_spill_to_disk_is_bitwise_the_host_eviction(tmp_path, registry):
    """Three co-range streams behind a budget of one resident: evicted to
    host memory and spilled to disk give the same bits as a service that
    never evicts, and the reference's service within f32 tolerance."""
    rng = np.random.default_rng(5)
    cfgs = [dict(n1=96, n2=64, r=8, seed=s) for s in (1, 2, 3)]
    spill = tmp_path / "spill"
    svcs = {"host": SketchService(max_resident=1, device="cpu"),
            "disk": SketchService(max_resident=1, spill_dir=str(spill),
                                  device="cpu"),
            "resident": SketchService(device="cpu")}
    jsvc = jstream.SketchService()
    tracer = obs_trace.install_tracer()
    try:
        sids = {k: [s.open(StreamConfig(**c)) for c in cfgs]
                for k, s in svcs.items()}
        jids = [jsvc.open(jstream.StreamConfig(**c)) for c in cfgs]
        for _ in range(3):
            for i, c in enumerate(cfgs):
                k = int(rng.integers(1, 33))
                row0 = int(rng.integers(0, c["n1"] - k + 1))
                H = rng.standard_normal((k, c["n2"])).astype(np.float32)
                for name, svc in svcs.items():
                    svc.update(sids[name][i], H, row0=row0)
                jsvc.update(jids[i], H, row0=row0)
        disk = svcs["disk"]
        evicted = [s for s in sids["disk"] if s in disk._evicted]
        assert len(evicted) == 2
        for s in evicted:            # on disk, a complete step each
            path = spill / f"stream_{s:08d}"
            assert ckpt.latest_step(str(path)) == 3
            assert disk._evicted[s].host is None
        # two at the opens, then every update touches an evicted stream
        assert registry.counter("sketch_spills_total").value() == 2 + 9
        for i in range(3):
            got = {k: (svcs[k].sketch(sids[k][i]).clone(),
                       svcs[k].corange(sids[k][i]).clone()) for k in svcs}
            for a, b in zip(got["disk"], got["host"]):
                assert bits_equal(a, b)
            for a, b in zip(got["disk"], got["resident"]):
                assert bits_equal(a, b)
            for a, want in zip(got["disk"], (jsvc.sketch(jids[i]),
                                             jsvc.corange(jids[i]))):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    a.numpy(), want, rtol=1e-5,
                    atol=1e-5 * max(np.abs(want).max(), 1e-30))
        for s in sids["disk"]:       # a restored stream's spill is gone
            assert s in disk._evicted or not (
                spill / f"stream_{s:08d}").exists()
    finally:
        obs_trace.uninstall_tracer()
    spills = {s.args["spill"] for s in tracer.spans
              if s.name == "service.evict"}
    assert spills == {True, False}


def test_a_failed_spill_raises_and_never_falls_back(tmp_path):
    """A spill that cannot be written raises and leaves the stream
    resident; one that cannot be read (torn) raises and leaves it
    evicted, restorable once repaired."""
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    svc = SketchService(max_resident=1, spill_dir=str(blocker),
                        device="cpu")
    a = svc.open(_cfg(0))
    with pytest.raises(OSError):
        svc.open(_cfg(1))
    assert svc.num_resident == 1 and svc.num_evicted == 0
    assert svc.stats()["streams"] == 1

    spill = tmp_path / "spill"
    svc = SketchService(max_resident=1, spill_dir=str(spill), device="cpu")
    a = svc.open(_cfg(0))
    svc.update(a, np.ones((4, 16), np.float32), row0=0)
    Y = svc.sketch(a).clone()
    svc.open(_cfg(1))                          # spills a
    step = spill / f"stream_{a:08d}" / "step_00000001"
    manifest = (step / "manifest.json").read_bytes()
    (step / "manifest.json").unlink()
    with pytest.raises(ckpt.TornCheckpointError):
        svc.sketch(a)                          # after spilling the other
    assert svc.num_resident == 0 and a in svc._evicted
    (step / "manifest.json").write_bytes(manifest)
    assert bits_equal(svc.sketch(a), Y)


# ---------------------------------------------------------------------------
# grid mode on (1,1,1): the queue, WAL replay, the recovery arc
# ---------------------------------------------------------------------------

def _deltas(rng, n=3, n1=32, n2=16):
    return [rng.standard_normal((n1, n2)).astype(np.float32)
            for _ in range(n)]


def test_wal_replay_onto_a_grid_service(tmp_path, grid):
    """Records apply as full-shape updates, bitwise; the reopened
    journal's watermark advances; a journaled row slab is refused."""
    rng = np.random.default_rng(8)
    cfg = _cfg(9)
    deltas = _deltas(rng)
    ref = SketchService(mesh=grid, device="cpu")
    rsid = ref.open(cfg)
    for H in deltas:
        ref.update(rsid, H)
    path = str(tmp_path / "ingest.wal")
    with wal_mod.WriteAheadLog(path) as wal:
        for H in deltas:
            wal.append(0, 0, H)
    wal2 = wal_mod.WriteAheadLog(path)
    assert wal2.depth == 3
    svc = SketchService(mesh=grid, device="cpu")
    sid = svc.open(cfg)
    nrec, words = wal_mod.replay(wal2, svc, sid_map={0: sid})
    assert nrec == 3 and words == sum(H.size for H in deltas)
    assert wal2.watermark == 3 and wal2.depth == 0
    assert wal2.truncate() == 0
    assert bits_equal(svc.sketch(sid), ref.sketch(rsid))
    wal2.append(0, 5, rng.standard_normal((4, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="row0"):
        wal_mod.replay(wal2, svc, sid_map={0: sid})
    wal2.close()


def test_submit_refuses_row0_on_a_grid(grid):
    svc = SketchService(mesh=grid, device="cpu")
    sid = svc.open(_cfg(0))
    with IngestQueue(svc) as q:
        with pytest.raises(ValueError, match="row0"):
            q.submit(sid, np.ones((4, 16), np.float32), 3)
        q.submit(sid, np.ones((32, 16), np.float32))     # row0 0 flows
        q.flush(raise_errors=True)
        st = q.stats()
    assert st["rejected"] == 1 and st["applied"] == 1
    direct = SketchService(mesh=grid, device="cpu")
    did = direct.open(_cfg(0))
    direct.update(did, np.ones((32, 16), np.float32))
    assert bits_equal(svc.sketch(sid), direct.sketch(did))


def _grid_pair(grid, rng, n=3):
    ref = SketchService(mesh=grid, device="cpu")
    svc = SketchService(mesh=grid, device="cpu")
    deltas = _deltas(rng, n)
    rids = [ref.open(_cfg(s)) for s in range(n)]
    sids = [svc.open(_cfg(s)) for s in range(n)]
    for rid, H in zip(rids, deltas):
        ref.update(rid, H)
    return ref, rids, svc, sids, deltas


def test_grid_partial_round_retry_applies_each_lane_once(grid):
    """Lane 1 of a 3-lane grid round fails once: the retry starts at lane
    1, and lane 0 does not apply twice."""
    ref, rids, svc, sids, deltas = _grid_pair(grid,
                                              np.random.default_rng(6))
    faults.arm("ingest.dispatch_lane", exc=faults.FaultInjected, times=1,
               match={"sid": sids[1]})
    with IngestQueue(svc, max_retries=2, backoff_base=0.0) as q:
        q.hold()                      # one batch -> one 3-lane round
        for sid, H in zip(sids, deltas):
            q.submit(sid, H)
        q.release()
        q.flush(raise_errors=True)
        st = q.stats()
    assert st["retries"] == 1 and st["quarantined"] == 0
    assert st["applied"] == 3 and st["errors"] == 0
    for sid, rid in zip(sids, rids):
        assert bits_equal(svc.sketch(sid), ref.sketch(rid))


def test_grid_poison_lane_is_excised_once(grid):
    """A lane that always fails is excised by the fallback; the lanes that
    landed before it are not applied again, and it never touched its
    accumulators."""
    ref, rids, svc, sids, deltas = _grid_pair(grid,
                                              np.random.default_rng(7))
    bad = sids[1]
    faults.arm("ingest.dispatch_lane", exc=faults.FaultInjected,
               times=None, match={"sid": bad})
    faults.arm("ingest.apply_lane", exc=faults.FaultInjected, times=None,
               match={"sid": bad})
    with IngestQueue(svc, max_retries=1, backoff_base=0.0) as q:
        q.hold()
        for sid, H in zip(sids, deltas):
            q.submit(sid, H)
        q.release()
        applied = q.flush()
        st = q.stats()
    assert applied == 2 and st["quarantined"] == 1 and st["errors"] == 1
    for sid, rid in zip(sids, rids):
        if sid != bad:
            assert bits_equal(svc.sketch(sid), ref.sketch(rid))
    assert not svc.sketch(bad).any()


def test_drain_reshard_resume_on_one_rank(grid):
    """Drain -> reshard every stream -> resume, bitwise a grid service
    that was never disturbed."""
    rng = np.random.default_rng(3)
    traffic = [(s, rng.standard_normal((32, 16)).astype(np.float32))
               for _ in range(3) for s in range(2)]
    ref = SketchService(mesh=grid, device="cpu")
    rids = [ref.open(_cfg(s)) for s in range(2)]
    for s, H in traffic:
        ref.update(rids[s], H)
    svc = SketchService(mesh=grid, device="cpu")
    sids = [svc.open(_cfg(s)) for s in range(2)]
    with IngestQueue(svc) as q:
        for s, H in traffic[:2]:
            q.submit(sids[s], H)
        assert drain_reshard_resume(q, (1, 1, 1)) == {"drained": 2,
                                                      "resharded": 2}
        for s, H in traffic[2:]:
            q.submit(sids[s], H)
        q.flush(raise_errors=True)
    for sid, rid in zip(sids, rids):
        assert bits_equal(svc.sketch(sid), ref.sketch(rid))


def test_reshard_refusals_move_nothing(grid):
    """``reshard`` of a local service, a grid that does not divide a
    stream, a grid larger than the world and an armed ``elastic.reshard``
    all raise before any block moves."""
    with pytest.raises(ValueError, match="distributed service"):
        SketchService(device="cpu").reshard((1, 1, 1))
    svc = SketchService(mesh=grid, device="cpu")
    sid = svc.open(_cfg(0))
    svc.update(sid, np.ones((32, 16), np.float32))
    Y = svc.sketch(sid)
    faults.arm("elastic.reshard", exc=faults.FaultInjected)
    with pytest.raises(faults.FaultInjected):
        svc.reshard((1, 1, 1))
    with pytest.raises(ValueError, match="not divisible"):
        svc.reshard((1, 1, 3))
    with pytest.raises(ValueError, match="needs 2 devices"):
        svc.reshard((2, 1, 1))
    assert svc.mesh is grid and svc.sketch(sid) is Y


def test_recovery_metrics_and_spans(tmp_path, grid, registry):
    """The recovery paths leave the reference's trail
    (``tests/test_obs.py``): the WAL depth gauge back at 0, replay, retry
    and reshard counted, the recovery arcs' spans named."""
    tracer = obs_trace.install_tracer()
    cfg = _cfg(0)
    try:
        svc = SketchService(device="cpu")
        sid = svc.open(cfg)
        wal = wal_mod.WriteAheadLog(str(tmp_path / "ingest.wal"))
        with IngestQueue(svc, wal=wal) as q:
            q.submit(sid, np.ones((4, 16), np.float32), 0)
            q.flush(raise_errors=True)
        wal.close()
        assert registry.gauge("stream_wal_depth").value() == 0
        svc2 = SketchService(device="cpu")
        sid2 = svc2.open(cfg)
        n, _ = wal_mod.replay(wal.path, svc2, sid_map={sid: sid2})
        assert n == 1
        assert registry.counter("stream_replays_total").value() == 1
        faults.arm("ingest.apply_round", exc=faults.FaultInjected, times=1)
        with IngestQueue(svc, max_retries=1, backoff_base=0.0) as q2:
            q2.submit(sid, np.ones((4, 16), np.float32), 0)
            q2.flush(raise_errors=True)
        faults.clear()
        assert registry.counter("ingest_retries_total").value() == 1
        dsvc = SketchService(mesh=grid, device="cpu")
        dsid = dsvc.open(cfg)
        with IngestQueue(dsvc) as q3:
            q3.submit(dsid, np.ones((32, 16), np.float32))
            out = drain_reshard_resume(q3, (1, 1, 1))
        assert out["resharded"] == 1
        assert registry.counter("stream_reshard_total").value() == 1
        text = registry.prometheus_text()
        for name in ("stream_wal_depth", "stream_replays_total",
                     "stream_reshard_total", "ingest_retries_total",
                     "ingest_quarantined_total"):
            assert name in text, name
    finally:
        obs_trace.uninstall_tracer()
    names = {s.name for s in tracer.spans}
    assert {"stream.wal_replay", "stream.reshard",
            "stream.drain_reshard_resume", "service.reshard"} <= names
    resh = next(s for s in tracer.spans if s.name == "stream.reshard")
    assert resh.args["old"] == "1x1x1" and resh.args["new"] == "1x1x1"
    assert resh.args["path"] == "none"   # the layouts coincide: no call


# ---------------------------------------------------------------------------
# the chaos drills, the launcher, the word functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", faults.SCENARIOS)
def test_chaos_scenarios_recover(scenario, tmp_path):
    res = faults.run_chaos_scenario(scenario, workdir=str(tmp_path),
                                    verbose=False, device="cpu")
    assert res["recovered"], res
    if scenario == "kill-worker":
        assert res["worker_died"] and res["replayed_records"] == 24
    if scenario == "torn-write":
        assert res["torn_steps"] == [2] and res["latest_step"] == 1
    if scenario == "eviction-storm":
        assert res["spills"] == 24 and res["evicted"] == 7


def test_unknown_chaos_scenario_raises():
    with pytest.raises(ValueError, match="unknown chaos scenario"):
        faults.run_chaos_scenario("meteor", verbose=False, device="cpu")


def test_launcher_runs_a_chaos_drill_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--chaos",
         "torn-write", "--device", "cpu"],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[chaos] torn-write: RECOVERED" in proc.stdout


def _grids(P):
    return [(a, b, P // (a * b)) for a in range(1, P + 1) if P % a == 0
            for b in range(1, P // a + 1) if (P // a) % b == 0]


@pytest.mark.parametrize("corange", [False, True])
def test_reshard_word_functions_are_the_references(corange):
    """Every pair of grids with P and Q <= 8."""
    kw = dict(l=17, n2=840, corange=corange)
    pairs = [(p, q) for P in range(1, 9) for Q in range(1, 9)
             for p in _grids(P) for q in _grids(Q)]
    assert len(pairs) == 38 * 38
    for p, q in pairs:
        assert tmodel.stream_reshard_words(1680, 24, p, q, **kw) == \
            jmodel.stream_reshard_words(1680, 24, p, q, **kw), (p, q)
        assert tmodel.stream_reshard_traffic_words(1680, 24, p, q, **kw) == \
            jmodel.stream_reshard_traffic_words(1680, 24, p, q, **kw), (p, q)
