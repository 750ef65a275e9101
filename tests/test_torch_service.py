"""repro_torch's sketch service, on the CPU: the lane-vs-solo oracle, the
port against the reference's service, admission/eviction, and the
``python -m repro_torch.launch.serve`` entry point.

The oracle is the port's own: lane i of ``update_ragged`` (and of
``update_batch``) must be bitwise ``update`` of stream i alone, with NaN
in every pad row, for float32 and bfloat16 streams.  (The reference's own
lane-vs-solo test is red on some hosts, so the port is not held to the
reference's bits.)  Against ``repro.stream.SketchService`` the port's f32
streams are held to ``rtol=1e-5``, ``atol=1e-5·max|ref|``: the two sum
the contraction in different orders.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro import stream as jstream
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve import make_sketch_service
from repro_torch.stream import SketchService, StreamConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    assert a.dtype == b.dtype and a.shape == b.shape
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def make_cfg(seed, kind="normal", dtype="float32", n1=96, n2=64, r=8,
             corange=True):
    return StreamConfig(n1=n1, n2=n2, r=r, seed=seed, kind=kind,
                        dtype=DTYPES[dtype], corange=corange)


def ragged_traffic(rng, cfgs, max_k=32):
    """One (index, H, row0) item per config, random heights and offsets."""
    items = []
    for i, c in enumerate(cfgs):
        k = int(rng.integers(1, max_k + 1))
        row0 = int(rng.integers(0, c.n1 - k + 1))
        items.append((i, rng.standard_normal((k, c.n2)).astype(np.float32),
                      row0))
    return items


def _pair():
    return SketchService(device="cpu"), SketchService(device="cpu")


def _assert_lanes_equal(svc, sids, ref, rids):
    for i, (s, r) in enumerate(zip(sids, rids)):
        assert bits_equal(svc.sketch(s), ref.sketch(r)), f"Y lane {i}"
        W, Wr = svc.corange(s), ref.corange(r)
        assert (W is None and Wr is None) or bits_equal(W, Wr), \
            f"W lane {i}"


@pytest.mark.parametrize("kind", ["normal", "uniform", "rademacher",
                                  "countsketch"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lanes", [1, 3, 7])
def test_ragged_lane_bitwise_equals_solo_update(kind, dtype, lanes):
    rng = np.random.default_rng(lanes * 31 + len(kind))
    cfgs = [make_cfg(100 + i, kind=kind, dtype=dtype) for i in range(lanes)]
    svc, ref = _pair()
    sids = [svc.open(c) for c in cfgs]
    rids = [ref.open(c) for c in cfgs]
    items = ragged_traffic(rng, cfgs)
    for i, H, row0 in items:
        ref.update(rids[i], H, row0=row0)
    svc.update_ragged([(sids[i], H, row0) for i, H, row0 in items],
                      pad_value=float("nan"))   # the all-NaN pad probe
    _assert_lanes_equal(svc, sids, ref, rids)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2 ** 16),
       dtype=st.sampled_from(list(DTYPES)),
       max_k=st.integers(1, 48),
       n_streams=st.integers(1, 6))
def test_ragged_lanes_property(seed, dtype, max_k, n_streams):
    """Random bucket mixes, offsets and repeated rounds: every round's
    lanes stay bitwise the solo updates."""
    rng = np.random.default_rng(seed)
    cfgs = [make_cfg(seed + i, dtype=dtype) for i in range(n_streams)]
    svc, ref = _pair()
    sids = [svc.open(c) for c in cfgs]
    rids = [ref.open(c) for c in cfgs]
    for _ in range(2):
        items = ragged_traffic(rng, cfgs, max_k=max_k)
        for i, H, row0 in items:
            ref.update(rids[i], H, row0=row0)
        svc.update_ragged([(sids[i], H, row0) for i, H, row0 in items],
                          pad_value=float("nan"))
    _assert_lanes_equal(svc, sids, ref, rids)


def test_ragged_mixed_signatures_and_bucket_edges():
    """Streams of different signatures (corange off, bf16, another kind)
    fuse in one call, grouped by (signature, bucket); explicit bucket
    edges give the same bits."""
    rng = np.random.default_rng(7)
    cfgs = [make_cfg(1), make_cfg(2, dtype="bfloat16"),
            make_cfg(3, corange=False), make_cfg(4, kind="rademacher")]
    svc, ref = _pair()
    sids = [svc.open(c) for c in cfgs]
    rids = [ref.open(c) for c in cfgs]
    for edges in (None, [8, 48]):
        items = ragged_traffic(rng, cfgs)
        for i, H, row0 in items:
            ref.update(rids[i], H, row0=row0)
        svc.update_ragged([(sids[i], H, row0) for i, H, row0 in items],
                          bucket_edges=edges, pad_value=float("nan"))
    _assert_lanes_equal(svc, sids, ref, rids)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_update_batch_lanes_bitwise_equal_solo(dtype):
    rng = np.random.default_rng(5)
    cfgs = [make_cfg(20 + i, dtype=dtype) for i in range(4)]
    svc, ref = _pair()
    sids = [svc.open(c) for c in cfgs]
    rids = [ref.open(c) for c in cfgs]
    H = rng.standard_normal((4, 9, 64)).astype(np.float32)
    row0s = [0, 17, 40, 87]
    svc.update_batch(sids, H, row0=row0s)
    for rid, h, r0 in zip(rids, H, row0s):
        ref.update(rid, h, row0=r0)
    _assert_lanes_equal(svc, sids, ref, rids)
    with pytest.raises(ValueError, match="shape signature"):
        other = svc.open(make_cfg(9, n2=32))
        svc.update_batch([sids[0], other], H[:2])


def test_service_matches_reference_service_f32():
    """The port's service against ``repro.stream.SketchService`` on the
    same traffic: update, update_ragged and update_batch, then the
    finalizers (nystrom, reconstruct) of a square stream."""
    rng = np.random.default_rng(11)
    cfgs = [dict(n1=64, n2=64, r=8, seed=2 ** 33 + 3),
            dict(n1=64, n2=64, r=8, seed=5)]
    tsvc = SketchService(device="cpu")
    jsvc = jstream.SketchService()
    tids = [tsvc.open(StreamConfig(**c)) for c in cfgs]
    jids = [jsvc.open(jstream.StreamConfig(**c)) for c in cfgs]

    def both(method, *args, **kw):
        getattr(tsvc, method)(*args[0], **kw)
        getattr(jsvc, method)(*args[1], **kw)

    A = [rng.standard_normal((c["n1"], c["n2"])).astype(np.float32)
         for c in cfgs]
    both("update", (tids[0], A[0][:20]), (jids[0], A[0][:20]), row0=0)
    both("update_ragged",
         ([(tids[0], A[0][20:50], 20), (tids[1], A[1][:7], 0)],),
         ([(jids[0], A[0][20:50], 20), (jids[1], A[1][:7], 0)],),
         pad_value=float("nan"))
    both("update_batch", (tids, np.stack([A[0][50:64], A[1][7:21]])),
         (jids, np.stack([A[0][50:64], A[1][7:21]])), row0=np.array([50, 7]))
    for t, j in zip(tids, jids):
        for got, want in ((tsvc.sketch(t), jsvc.sketch(j)),
                          (tsvc.corange(t), jsvc.corange(j))):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=1e-5,
                atol=1e-5 * max(np.abs(want).max(), 1e-30))
    B, C = tsvc.nystrom(tids[0])
    jB, jC = jsvc.nystrom(jids[0])
    np.testing.assert_allclose(C.numpy(), np.asarray(jC), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jC)).max())
    low = tsvc.reconstruct(tids[0], rank=8)
    assert low.matrix().shape == (64, 64)
    assert tsvc.stats()["updates"] == 5


def test_ragged_validates_before_mutating():
    cfg = make_cfg(8)
    svc = SketchService(device="cpu")
    a, b = svc.open(cfg), svc.open(cfg)
    H = np.ones((4, cfg.n2), np.float32)
    before = svc.sketch(a).clone()
    with pytest.raises(ValueError):
        svc.update_ragged([(a, H, 0), (b, H, cfg.n1)])   # lane b off the end
    assert bits_equal(svc.sketch(a), before)
    with pytest.raises(ValueError, match="distinct"):
        svc.update_ragged([(a, H, 0), (a, H, 0)])
    with pytest.raises(ValueError):
        svc.update_ragged([])
    assert svc.stats()["updates"] == 0


def test_evicted_then_touched_restores_bitwise():
    rng = np.random.default_rng(9)
    cfg = make_cfg(50)
    svc, ref = SketchService(max_resident=2, device="cpu"), \
        SketchService(device="cpu")
    sid, rid = svc.open(cfg), ref.open(cfg)
    H = rng.standard_normal((16, cfg.n2)).astype(np.float32)
    svc.update(sid, H, row0=8)
    ref.update(rid, H, row0=8)
    svc.evict(sid)
    assert svc.num_evicted == 1 and svc.num_resident == 0
    # touch via a ragged batch: the restore is transparent AND bitwise
    H2 = rng.standard_normal((5, cfg.n2)).astype(np.float32)
    svc.update_ragged([(sid, H2, 40)], pad_value=float("nan"))
    ref.update(rid, H2, row0=40)
    assert svc.num_evicted == 0 and svc.num_resident == 1
    _assert_lanes_equal(svc, [sid], ref, [rid])
    svc.open(cfg), svc.open(cfg)                 # evicts sid again
    Y, W = svc.close(sid)                        # close restores first
    assert bits_equal(Y, ref.sketch(rid)) and bits_equal(W, ref.corange(rid))


def test_admission_evicts_lru_respecting_qos():
    cfg = make_cfg(51)
    svc = SketchService(max_resident=2, device="cpu")
    pinned = svc.open(cfg, qos="pinned")
    best = svc.open(cfg, qos="best_effort")
    svc.sketch(best)                        # best_effort is the HOTTEST...
    std = svc.open(cfg, qos="standard")     # ...but lowest class evicts first
    assert svc.num_resident == 2 and set(svc._streams) == {pinned, std}
    svc.sketch(std)
    again = svc.open(cfg, qos="standard")   # evicts std (pinned survives)
    assert set(svc._streams) == {pinned, again}
    svc2 = SketchService(max_resident=1, device="cpu")
    svc2.open(cfg, qos="pinned")
    with pytest.raises(RuntimeError, match="admission refused"):
        svc2.open(cfg, qos="pinned")
    # batch lanes never evict each other
    svc3 = SketchService(max_resident=1, device="cpu")
    a, b = svc3.open(cfg), svc3.open(cfg)
    with pytest.raises(RuntimeError, match="admission refused"):
        svc3.update_ragged([(s, np.ones((4, cfg.n2), np.float32), 0)
                            for s in (a, b)])


def test_stats_updates_is_a_lifetime_counter_and_metrics():
    prev = obs_metrics.set_metrics(None)
    try:
        svc = SketchService(device="cpu")
        cfg = make_cfg(60)
        a, b = svc.open(cfg), svc.open(cfg)
        H = np.ones((4, cfg.n2), np.float32)
        svc.update(a, H, row0=0)
        svc.update_ragged([(a, H[:3], 8), (b, H, 0)])
        assert svc.stats() == {"streams": 2, "resident": 2, "evicted": 0,
                               "updates": 3, "lane_batches": 1}
        svc.close(a)
        svc.close(b)
        assert svc.stats()["updates"] == 3
        m = obs_metrics.get_metrics()
        assert m.counter("sketch_ragged_real_rows_total").value() == 7
        # one pow2 bucket of height 4 holding 2 lanes: 2·4 − 7 pad rows
        assert m.counter("sketch_ragged_padded_rows_total").value() == 1
        assert m.counter("sketch_updates_total").value(path="ragged") == 2
    finally:
        obs_metrics.set_metrics(prev)


def test_unknown_sid_and_unported_parts_raise():
    svc = SketchService(device="cpu")
    sid = svc.open(make_cfg(61))
    svc.close(sid)
    for op in (lambda: svc.close(sid), lambda: svc.close(999),
               lambda: svc.evict(999),
               lambda: svc.update(sid, np.ones((4, 64), np.float32), 0),
               lambda: svc.sketch(999)):
        with pytest.raises(ValueError, match="unknown stream id"):
            op()
    # once stubs: spill_dir is accepted, and reshard needs a grid service
    assert SketchService(spill_dir="x", device="cpu").spill_dir == "x"
    with pytest.raises(ValueError, match="distributed service"):
        svc.reshard((2, 1, 1))


def test_service_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SketchService()


def test_launcher_runs_on_cpu_and_prints_rate():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
         "sketch", "--device", "cpu", "--streams", "4", "--updates", "2",
         "--n1", "48", "--n2", "32", "--r", "4", "--max-rows", "9",
         "--window", "3", "--metrics"],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "updates/s" in proc.stdout
    assert "8 updates over 4 streams" in proc.stdout
    assert "ingest_applied_total 8" in proc.stdout
