"""repro_torch.obs against repro.obs, on the CPU.

The port's metrics registry and tracer are copies of the reference's
pure-Python modules: the same calls must give the same Prometheus text
(exactly: it is text), the same snapshots and the same Chrome-trace
structure.  Plus what the serving path publishes into them: service and
queue metrics, and the ingest queue's apply spans parented across threads
under the submitting request's span.

The comm ledger and its report (the reference's ``tests/test_obs.py``
ledger cases, with canned ``COMM`` deltas where the reference feeds canned
HLO, and a fixed grid for its drift-flag property), and against the
reference: the audits' predicted words and floors exactly, the same site
names and call counts for the same calls, the same report text.
"""
import dataclasses
import json
import math
import types

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro import obs as jobs
from repro.core import nystrom as jnys
from repro.obs import ledger as jledger
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.stream import distributed as jdist
from repro.stream import service as jservice
from repro.stream import state as jstate
from repro_torch import obs as tobs
from repro_torch.core import nystrom as tnys
from repro_torch.obs import ledger as tledger
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.parallel import collectives as tcol
from repro_torch.parallel import grad_compress as tgc
from repro_torch.stream import IngestQueue, SketchService, StreamConfig
from repro_torch.stream import distributed as tdist


@pytest.fixture(autouse=True)
def _fresh_registries():
    prev = tmetrics.set_metrics(None)
    ttrace.uninstall_tracer()
    yield
    tmetrics.set_metrics(prev)
    ttrace.uninstall_tracer()


def _drive(mod, values):
    reg = mod.MetricsRegistry()
    c = reg.counter("requests_total", "requests served")
    c.inc()
    c.inc(2, path="ragged")
    c.inc(0.5, path="single")
    reg.counter("never_total")                 # registered, never touched
    g = reg.gauge("queue_depth", "depth")
    g.set(3)
    g.inc(2, shard="a")
    g.dec(0.25, shard="a")
    h = reg.histogram("lat_seconds", "latency", buckets=(0.5, 2.0, 8.0))
    for i, v in enumerate(values):
        h.observe(v, path="ragged" if i % 2 else "single")
    reg.histogram("empty_seconds")
    return reg


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2 ** 16), n=st.integers(0, 40))
def test_prometheus_text_matches_reference(seed, n):
    values = np.random.default_rng(seed).exponential(1.0, n).tolist()
    want = _drive(jmetrics, values)
    got = _drive(tmetrics, values)
    assert got.prometheus_text() == want.prometheus_text()
    assert got.snapshot() == want.snapshot()
    h_t, h_j = got.histogram("lat_seconds"), want.histogram("lat_seconds")
    for q in (0, 50, 99, 100):
        assert h_t.percentile(q, path="ragged") == h_j.percentile(
            q, path="ragged")


def test_registry_kind_clash_and_empty_registry():
    reg = tmetrics.MetricsRegistry()
    assert reg.prometheus_text() == ""
    reg.counter("x_total")
    with pytest.raises(TypeError):
        reg.gauge("x_total")
    with pytest.raises(ValueError):
        reg.counter("x_total").inc(-1)


def test_chrome_trace_has_the_reference_structure(tmp_path):
    events = {}
    for name, mod in (("port", ttrace), ("ref", jtrace)):
        tracer = mod.Tracer()
        with tracer.span("outer", cat="test", k=1):
            with tracer.span("inner"):
                pass
        path = tracer.export_chrome(str(tmp_path / f"{name}.json"))
        with open(path) as f:
            events[name] = json.load(f)["traceEvents"]
    strip = [[{k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
              for e in evs] for evs in (events["port"], events["ref"])]
    assert strip[0] == strip[1]
    assert ttrace.span("anything") is ttrace.span("else")   # no-op when off


def test_service_and_queue_publish_and_spans_cross_threads():
    tracer = ttrace.install_tracer()
    svc = SketchService(device="cpu")
    sid = svc.open(StreamConfig(n1=32, n2=16, r=4, seed=1))
    with IngestQueue(svc, depth=8, window=4) as q:
        q.hold()
        with ttrace.span("client.request", cat="test"):
            q.submit(sid, np.ones((3, 16), np.float32), 0, timeout=60)
        q.release()
        q.flush(raise_errors=True, timeout=60)
    names = {s.name: s for s in tracer.spans}
    client, apply_ = names["client.request"], names["ingest.apply_round"]
    assert apply_.parent_id == client.span_id
    assert apply_.tid != client.tid
    assert names["service.update_ragged"].args == {"lanes": 1, "bucket": 4}
    text = tmetrics.get_metrics().prometheus_text()
    assert "ingest_applied_total 1" in text
    assert 'sketch_updates_total{path="ragged"} 1' in text
    assert "sketch_ragged_padded_rows_total 1" in text


# ---------------------------------------------------------------------------
# the comm ledger (the reference's cases, canned COMM deltas for canned HLO)
# ---------------------------------------------------------------------------

@pytest.fixture
def led():
    tledger.uninstall_ledger()
    yield tledger.install_ledger()
    tledger.uninstall_ledger()


def _received(**words):
    """A dispatch that receives canned words: bumps the counters as the
    collectives do (``allreduce_mean``: ``grad_compress.COMM``)."""
    for kind, w in words.items():
        rec = tgc.COMM if kind == "allreduce_mean" else tcol.COMM[kind]
        rec["words"] += w
        rec["calls"] += 1


#: a dispatch that received one 128-word all-reduce (the reference's
#: ``_AR_512``: 512 bytes of f32)
_AR_128 = {"all_reduce": 128}


def _observed(ledger, name, args, words, **kw):
    """``words`` received inside an observation of the installed
    ``ledger``."""
    assert tledger.get_ledger() is ledger
    with tledger.observing(name, args, **kw) as o:
        _received(**words)
    return o.site


class _FakeFn:
    """The reference's stand-in for a jitted function: ``.lower()
    .compile().as_text()`` gives canned HLO."""

    def __init__(self, text: str):
        self._text = text

    def lower(self, *args):
        return self

    def compile(self):
        return self

    def as_text(self):
        return self._text


def _hlo_all_reduce(words: int) -> _FakeFn:
    """An f32 all-reduce of ``words`` elements (4·words operand bytes)."""
    return _FakeFn(f"HloModule m, num_partitions=4\n"
                   f"%p0 = f32[{words}]{{0}} parameter(0)\n"
                   f"%ar = f32[{words}]{{0}} all-reduce(%p0), "
                   f"replica_groups={{{{0,1,2,3}}}}\n")


def test_ledger_observe_accumulates_per_signature(led):
    x = torch.ones((4, 4))
    led.observe("t.op", (x,))
    led.observe("t.op", (x,), wall_s=0.5)
    assert len(led) == 1
    site = led.site("t.op")
    assert site.calls == 2 and site.wall_s == 0.5
    # a dispatch that moves nothing: zero words at a zero floor
    assert site.measured_bytes_per_call == 0.0
    assert site.bound_fraction == 1.0 and site.drift == 0.0
    _observed(led, "t.op", (torch.ones((8, 4)),), {})
    assert len(led) == 2                    # new signature, new site
    assert led.site("t.op").calls == 2


def test_ledger_observing_reads_the_comm_delta_by_kind(led):
    words = dict(all_gather=10, reduce_scatter=6, all_reduce=3.5,
                 all_to_all=4, redistribute=2, allreduce_mean=5)
    site = _observed(led, "t.kinds", (torch.ones(2),), words)
    site = _observed(led, "t.kinds", (torch.ones(2),), words)
    cw = site.collectives()
    assert cw.by_kind == pytest.approx(words)
    assert cw.counts == dict.fromkeys(words, 1)
    assert cw.total == 30.5 and cw.redistribute_total == 6.0
    assert site.measured_words == 61.0 and site.calls == 2
    assert site.measured_words_per_call == 30.5
    assert site.wall_s >= 0.0


def test_ledger_observing_without_a_ledger_is_a_shared_noop():
    tledger.uninstall_ledger()

    def audit():
        raise AssertionError("an audit evaluated with no ledger installed")
    ob = tledger.observing("t.off", (torch.ones(1),), audit)
    assert ob is tledger.NO_OBSERVATION
    with ob:
        _received(all_gather=7)
    assert tledger.get_ledger() is None


def test_ledger_observing_evaluates_the_audit_when_installed(led):
    with tledger.observing("t.audit", (torch.ones(1),),
                           lambda a, b: (a, b), (12.0, 3.0)) as o:
        _received(all_reduce=12)
    assert (o.site.predicted_words, o.site.lower_bound_words) == (12.0, 3.0)
    assert o.site.drift == 0.0 and o.site.bound_fraction == 4.0


def test_ledger_counter_reset_inside_an_observation_raises(led):
    _received(all_gather=5)
    with pytest.raises(RuntimeError, match="reset"):
        with tledger.observing("t.reset", ()):
            tcol.reset_comm()


def test_ledger_kinds_are_the_collectives_kinds():
    assert tledger.COLLECTIVE_KINDS == tcol.KINDS


def test_ledger_record_analytic_site(led):
    led.record("plan.x", predicted_words=10.0, lower_bound_words=5.0,
               wall_s=0.1, detail=("a",))
    led.record("plan.x", wall_s=0.2, detail=("a",))
    site = led.site("plan.x")
    assert site.calls == 2 and site.wall_s == pytest.approx(0.3)
    assert site.measured_bytes_per_call is None
    assert site.measured_words is None and site.collectives() is None
    assert site.bound_fraction is None and site.drift is None


def test_ledger_audit_conventions(led):
    args = (torch.zeros((2, 2)),)
    # measured 128 words = 512 B over a zero floor / zero prediction
    s = _observed(led, "inf.case", args, {"all_reduce": 128})
    assert s.measured_bytes_per_call == 512.0
    assert s.measured_words_per_call == 128.0
    assert s.bound_fraction == math.inf and s.drift == math.inf
    led.clear()
    s = _observed(led, "exact.case", args, {"all_reduce": 128},
                  predicted_words=128.0, lower_bound_words=64.0)
    assert s.drift == 0.0 and s.bound_fraction == 2.0
    assert led.total_measured_bytes() == 512.0
    assert led.total_measured_bytes("other") == 0.0


def test_ledger_itemsize_scales_words(led):
    """64 f64 elements received are 512 bytes: the words are the bytes
    over the itemsize."""
    s = _observed(led, "f64.case", (torch.zeros(1, dtype=torch.float64),),
                  {"all_reduce": 64}, itemsize=8)
    assert s.measured_bytes_per_call == 512.0
    assert s.measured_words_per_call == 64.0


def test_ledger_observe_takes_words_and_calls_by_kind(led):
    s = led.observe("t.d", (), measured_words={"all_gather": 8.0})
    assert s.measured_words_per_call == 8.0
    assert s.collectives().counts == {}
    s = led.observe("t.p", (), measured_words={"all_gather": 8.0},
                    measured_calls={"all_gather": 2}, count=2)
    assert s.measured_words_per_call == 4.0
    assert s.collectives().counts == {"all_gather": 1.0}


# ---------------------------------------------------------------------------
# report: honesty table, drift flags, autotune revalidation
# ---------------------------------------------------------------------------

def test_honesty_report_renders():
    led = tledger.CommLedger()
    led.observe("site.a", (torch.zeros(1),), measured_words=_AR_128,
                predicted_words=100.0, lower_bound_words=64.0, wall_s=0.5)
    led.record("site.b", predicted_words=7.0)
    txt = tobs.honesty_report(led)
    lines = txt.splitlines()
    assert lines[0].split() == ["site", "calls", "pred_words", "meas_words",
                                "thm_floor", "bound_frac", "drift", "wall_s"]
    assert "site.a" in txt and "site.b" in txt
    assert "128" in txt                     # measured words rendered
    brow = next(ln for ln in lines if ln.startswith("site.b"))
    assert "-" in brow
    # roofline column: 128 words/call at 256 words/s over 0.5 s wall = 1.0
    txt2 = tobs.honesty_report(led, machine_words_per_s=256.0)
    assert "roofline_frac" in txt2.splitlines()[0]
    arow = next(ln for ln in txt2.splitlines() if ln.startswith("site.a"))
    assert arow.rstrip().endswith("1")


@pytest.mark.parametrize("machine", [None, 256.0], ids=["plain", "roofline"])
def test_honesty_report_text_is_the_reference_text(machine):
    """The same sites in both ledgers (canned HLO in the reference's,
    the same words as counter deltas in the port's) render the same
    table, character for character."""
    jl, tl = jledger.CommLedger(), tledger.CommLedger()
    cases = [("site.a", 128, 100.0, 64.0, 0.5), ("site.c", 32, 32.0, 0.0,
                                                  0.25),
             ("site.z", 0, 0.0, 0.0, 0.125)]
    for i, (name, words, pred, floor, wall) in enumerate(cases):
        a = np.zeros(i + 1, np.float32)
        jl.observe(name, _hlo_all_reduce(words) if words else
                   _FakeFn("HloModule m\n"), (a,), predicted_words=pred,
                   lower_bound_words=floor, wall_s=wall)
        tl.observe(name, (torch.from_numpy(a),),
                   measured_words={"all_reduce": words} if words else {},
                   predicted_words=pred, lower_bound_words=floor,
                   wall_s=wall)
    for led in (jl, tl):
        led.record("site.b", predicted_words=7.0, lower_bound_words=2.0,
                   wall_s=0.75, detail=("x",))
    assert tobs.honesty_report(tl, machine) == jobs.honesty_report(jl,
                                                                   machine)
    assert tobs.report_rows(tl) == jobs.report_rows(jl)


#: predicted words against 128 measured: drifts 63, 3, 1, 0.28, 0.25 (in
#: floats), 0, -0.2, -0.5, -0.95, and thresholds from 0 up, with the
#: edges drift == threshold (not flagged: the predicate is strict)
DRIFT_PREDS = [2.0, 32.0, 64.0, 100.0, 102.4, 128.0, 160.0, 256.0, 2560.0]
DRIFT_THRESHOLDS = [0.0, 0.25, 0.5, 1.0, 3.0]


@pytest.mark.parametrize("threshold", DRIFT_THRESHOLDS)
@pytest.mark.parametrize("pred", DRIFT_PREDS)
def test_drift_flag_predicate_grid(pred, threshold):
    """A site flags iff |measured - predicted| / predicted > threshold,
    and the reference flags the same site with the same drift."""
    measured = 128.0
    led = tledger.CommLedger()
    led.observe("s", (torch.zeros(1),),
                measured_words={"all_reduce": measured},
                predicted_words=pred)
    drift = (measured - pred) / pred
    flags = tobs.drift_flags(led, threshold=threshold)
    assert bool(flags) == (abs(drift) > threshold)
    if flags:
        assert flags[0][1] == pytest.approx(drift)
    jl = jledger.CommLedger()
    jl.observe("s", _hlo_all_reduce(128), (np.zeros(1),),
               predicted_words=pred)
    jflags = jobs.drift_flags(jl, threshold=threshold)
    assert [(s.name, d) for s, d in flags] == [(s.name, d)
                                                for s, d in jflags]


def test_drift_flags_sorted_and_validated():
    led = tledger.CommLedger()
    led.observe("small", (torch.zeros(1),), measured_words=_AR_128,
                predicted_words=100.0)      # drift +0.28
    led.observe("big", (torch.zeros(2),), measured_words=_AR_128,
                predicted_words=32.0)       # drift +3.0
    led.record("analytic", predicted_words=1.0)   # never flags
    flags = tobs.drift_flags(led, threshold=0.25)
    assert [s.name for s, _ in flags] == ["big", "small"]
    with pytest.raises(ValueError):
        tobs.drift_flags(led, threshold=-0.1)


def test_revalidate_autotune_pops_drifted_entries(tmp_path):
    from repro_torch.plan.autotune import AutotuneCache
    cache = AutotuneCache(str(tmp_path / "tune.json"))
    cache.put("k/drifted", {"variant": "v"})
    cache.put("k/fine", {"variant": "v"})
    led = tledger.CommLedger()
    led.observe("s1", (torch.zeros(1),), measured_words=_AR_128,
                predicted_words=32.0, cache_key="k/drifted")
    led.observe("s2", (torch.zeros(2),), measured_words=_AR_128,
                predicted_words=128.0, cache_key="k/fine")   # drift 0
    led.record("s3", predicted_words=1.0, cache_key="k/fine")  # analytic
    popped = tobs.revalidate_autotune(led, cache, threshold=0.25)
    assert popped == ["k/drifted"]
    assert cache.get("k/drifted") is None
    assert cache.get("k/fine") is not None
    assert AutotuneCache(str(tmp_path / "tune.json")).get("k/drifted") \
        is None                             # the pop reached the file
    # idempotent: already-popped keys return nothing the second time
    assert tobs.revalidate_autotune(led, cache, threshold=0.25) == []


def test_plan_execute_records_analytic_site(led):
    from repro_torch.plan import plan_sketch
    from repro_torch.plan.autotune import cache_key
    plan = plan_sketch(32, 16, 8, P=1)
    out = plan.execute(np.ones((32, 16), np.float32), device="cpu")
    assert tuple(out.shape) == (32, 8)
    site = next(s for s in led.sites() if s.name.startswith("plan.execute["))
    assert site.name == f"plan.execute[sketch/{plan.variant}]"
    assert site.calls == 1 and site.wall_s > 0
    assert site.cache_key == cache_key(plan)
    assert site.measured_bytes_per_call is None   # analytic-only
    assert (site.predicted_words, site.lower_bound_words) == (
        plan.predicted_words, plan.lower_bound_words)


def test_observability_install_and_uninstall():
    tracer, ledger, metrics = tobs.install_observability(max_spans=8)
    try:
        assert tobs.get_ledger() is ledger and ttrace.get_tracer() is tracer
        assert metrics is tmetrics.get_metrics()
    finally:
        prev = tobs.uninstall_observability()
    assert prev == (tracer, ledger)
    assert tobs.get_ledger() is None and ttrace.get_tracer() is None
    assert set(jobs.__all__) <= set(tobs.__all__)


# ---------------------------------------------------------------------------
# the sites' reference numbers against the reference's, exactly
# ---------------------------------------------------------------------------

AUDIT_GRIDS = [(1, 1, 1), (4, 1, 1), (2, 2, 1), (1, 2, 2), (2, 2, 2),
               (1, 1, 4), (8, 1, 1), (2, 1, 4)]
#: (n1, n2, r, corange, l): r >= n2 in the last but one (no floor)
AUDIT_CFGS = [(64, 256, 16, True, None), (64, 256, 16, False, None),
              (4096, 4096, 256, True, None), (32768, 32768, 512, True, None),
              (16, 8, 8, True, None), (32, 64, 8, True, 5)]


def _jmesh(grid):
    return types.SimpleNamespace(shape=dict(zip("xyz", grid)),
                                 devices=np.empty(grid))


def _cfgs(case):
    n1, n2, r, corange, l = case
    return (jstate.StreamConfig(n1=n1, n2=n2, r=r, seed=1, corange=corange,
                                l=l),
            StreamConfig(n1, n2, r=r, seed=1, corange=corange, l=l))


@pytest.mark.parametrize("case", AUDIT_CFGS, ids=str)
@pytest.mark.parametrize("grid", AUDIT_GRIDS, ids=str)
def test_stream_audit_is_the_reference_audit(grid, case):
    jcfg, tcfg = _cfgs(case)
    jself = types.SimpleNamespace(cfg=jcfg, mesh=_jmesh(grid),
                                  axes=("x", "y", "z"), backend="jnp",
                                  _audits={})
    tself = types.SimpleNamespace(cfg=tcfg,
                                  mesh=types.SimpleNamespace(shape=grid),
                                  _audits={})
    for k in (None, 4, 16):
        want = jdist.ShardedStreamingSketch._audit(jself, k)
        got = tdist.ShardedStreamingSketch._audit(tself, k)
        assert got == want, (k, got, want)
        assert tdist.ShardedStreamingSketch._audit(tself, k) is got


@pytest.mark.parametrize("case", AUDIT_CFGS, ids=str)
@pytest.mark.parametrize("grid", AUDIT_GRIDS, ids=str)
def test_dist_audit_is_the_reference_audit(grid, case):
    jcfg, tcfg = _cfgs(case)
    jself = types.SimpleNamespace(mesh=_jmesh(grid), axes=("x", "y", "z"),
                                  backend="jnp", _audit={})
    tself = types.SimpleNamespace(mesh=types.SimpleNamespace(shape=grid),
                                  _audit={})
    want = jservice.SketchService._dist_audit(jself, jcfg)
    got = SketchService._dist_audit(tself, tcfg)
    assert got == want
    # one full-shape grid update is the sharded stream's full update
    sself = types.SimpleNamespace(cfg=tcfg,
                                  mesh=types.SimpleNamespace(shape=grid),
                                  _audits={})
    assert got == tdist.ShardedStreamingSketch._audit(sself, None)


FUSED_CASES = [(64, 16, (4, 1, 1), (1, 1, 4)), (64, 16, (2, 2, 1), (4, 1, 1)),
               (4096, 256, (4, 1, 1), (1, 2, 2)),
               (32768, 512, (4, 1, 1), (1, 1, 4)),
               (32768, 512, (4, 1, 1), (2, 1, 2)),
               (256, 128, (32, 1, 1), (1, 1, 32)),
               (4096, 256, (2, 2, 1), (1, 2, 2)), (16, 16, (2, 1, 1),
                                                   (1, 1, 2))]


@pytest.mark.parametrize("n,r,p,q", FUSED_CASES, ids=str)
def test_fused_audit_is_the_reference_audit(n, r, p, q):
    for backend in ("jnp", "pallas"):
        assert tnys._fused_audit(n, r, p, q) == jnys._fused_audit(
            n, r, p, q, backend)


def test_same_calls_leave_the_same_sites_in_both_packages():
    """One sequence of local service calls and one-card plans in each
    package: the same site names with the same call counts (the port's
    variant names mapped to the reference's)."""
    import jax.numpy as jnp
    from repro.plan import plan_nystrom as jplan_nystrom
    from repro.plan import plan_sketch as jplan_sketch
    from repro.plan import plan_stream as jplan_stream
    from repro_torch.plan import plan_nystrom, plan_sketch, plan_stream
    from repro_torch.stream import SparseRows

    rng = np.random.default_rng(5)
    n1, n2, r = 64, 32, 8
    H8, H64 = (rng.standard_normal((k, n2)).astype(np.float32)
               for k in (8, n1))
    Hb = rng.standard_normal((2, 4, n2)).astype(np.float32)
    lanes = [rng.standard_normal((k, n2)).astype(np.float32)
             for k in (3, 5, 9, 2)]
    D = (rng.standard_normal((4, n2)) * (rng.random((4, n2)) < 0.25)
         ).astype(np.float32)
    A = rng.standard_normal((n1, n1)).astype(np.float32)
    names = {"local_torch": "local_xla", "cuda_fused": "pallas_fused"}

    def drive(svc, cfg, sparse, plans, execute):
        sids = [svc.open(cfg(s)) for s in range(4)]
        svc.update(sids[0], H8.copy(), row0=0)
        svc.update(sids[0], H64.copy())
        svc.update_batch(sids[:2], Hb.copy(), row0=[0, 8])
        for _ in range(2):
            svc.update_ragged([(sid, H.copy(), 0)
                               for sid, H in zip(sids, lanes)])
        svc.update_sparse(sids[1], sparse, row0=4)
        svc.update_sparse_batch(sids[2:], [sparse, sparse], row0=[0, 4])
        for plan in plans:
            execute(plan)

    def sites(led, rename):
        return sorted((rename(s.name), s.calls) for s in led.sites())

    tl = tledger.install_ledger()
    jl = jledger.install_ledger()
    try:
        drive(SketchService(device="cpu"),
              lambda s: StreamConfig(n1, n2, r=r, seed=s),
              SparseRows.from_dense(torch.from_numpy(D.copy())),
              [dataclasses.replace(plan_sketch(n1, n1, r), variant=
                                   "local_torch"),
               dataclasses.replace(plan_nystrom(n1, r), variant=
                                   "local_torch"),
               plan_stream(n1, n1, r, chunk_rows=16)],
              lambda p: p.execute(torch.from_numpy(A.copy()), seed=1,
                                  device="cpu"))
        drive(jservice.SketchService(),
              lambda s: jstate.StreamConfig(n1=n1, n2=n2, r=r, seed=s),
              jstate.SparseRows.from_dense(D.copy()),
              [dataclasses.replace(jplan_sketch(n1, n1, r), variant=
                                   "local_xla"),
               dataclasses.replace(jplan_nystrom(n1, r), variant=
                                   "local_xla"),
               jplan_stream(n1, n1, r, chunk_rows=16)],
              lambda p: p.execute(jnp.asarray(A), seed=1))
    finally:
        tledger.uninstall_ledger()
        jledger.uninstall_ledger()

    def rename(name):
        for a, b in names.items():
            name = name.replace(f"/{a}]", f"/{b}]")
        return name
    got, want = sites(tl, rename), sites(jl, str)
    assert got == want
    assert ("service.update_ragged", 2) in got
    assert [c for n, c in got if n == "service.update[sparse]"] == [1, 1]


def test_serve_launcher_fills_the_ledger():
    """``run_sketch`` under ``install_observability``: the ragged ingest's
    buckets are observed at ``service.update_ragged``, each moving 0
    words at a 0 floor on one device."""
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--streams", "4", "--updates", "2", "--n1",
         "64", "--n2", "32", "--r", "4", "--max-rows", "8"])
    tracer, ledger, _ = tobs.install_observability()
    try:
        out = serve.run_sketch(args)
    finally:
        tobs.uninstall_observability()
    assert out["updates_per_s"] > 0
    sites = [s for s in ledger.sites() if s.name == "service.update_ragged"]
    assert sites and sum(s.calls for s in sites) >= 1
    for s in sites:
        assert (s.measured_words_per_call, s.predicted_words,
                s.lower_bound_words, s.bound_fraction, s.drift) == (
            0.0, 0.0, 0.0, 1.0, 0.0)
    assert any(sp.name == "service.update_ragged" for sp in tracer.spans)


def test_serve_main_prints_the_honesty_report(tmp_path, capsys):
    from repro_torch.launch import serve
    out = tmp_path / "trace.json"
    serve.main(["--device", "cpu", "--streams", "2", "--updates", "1",
                "--n1", "32", "--n2", "16", "--r", "4", "--max-rows", "4",
                "--trace-out", str(out)])
    text = capsys.readouterr().out
    assert out.exists()
    assert "site" in text and "service.update_ragged" in text
    assert "pred_words" in text and "thm_floor" in text
    assert tobs.get_ledger() is None
