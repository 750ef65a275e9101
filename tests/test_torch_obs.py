"""repro_torch.obs against repro.obs, on the CPU.

The port's metrics registry and tracer are copies of the reference's
pure-Python modules: the same calls must give the same Prometheus text
(exactly: it is text), the same snapshots and the same Chrome-trace
structure.  Plus what the serving path publishes into them: service and
queue metrics, and the ingest queue's apply spans parented across threads
under the submitting request's span.
"""
import json

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st

from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.stream import IngestQueue, SketchService, StreamConfig


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
