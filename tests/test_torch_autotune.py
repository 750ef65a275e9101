"""The port's measured autotuner (``repro_torch.plan.autotune``) against the
reference's ``repro.plan.autotune``, on the CPU.

Held to:

  * the reference's behaviour with injected timers (no clock): the cache
    round trip (a miss measures, a fresh cache object at the same path is
    a pure hit, a stale or unreadable file is an empty cache), the
    revalidation of a pow2-bucket hit against the exact dims, rescored
    predictions after a measurement and after a hit, records, presets,
    the two-grid (p, q) sweep and the fused decision's cache round trip
    (``tests/test_plan.py``, ``tests/test_two_grid.py``,
    ``tests/test_two_grid_fused.py``);
  * the reference's sweep, in order, on the ``cpu`` entry: the
    (variant, grid, q_grid, chunk_rows) of ``_measurable_candidates``
    wherever P > 1 and for streams, on a fixed set of shapes; and with
    one timer the same winner with the same ``predicted_words``.  Where
    grids tie on network time the two models' device-memory words break
    the tie each their own way (``_measurable_candidates``): on tiny
    memory-bound shapes such as (n, r, P) = (256, 4, 8) the orders
    differ, and the fixed set holds none of them;
  * the port's own fit: a candidate whose device-memory bytes exceed
    ``machine.hbm_bytes``, or one of whose kernels takes more shared
    memory than ``machine.smem_bytes``, is not timed, and the plan's
    notes (and ``explain``) say why;
  * one world of four gloo processes (``torch_dist_helper.
    autotune_worker``): every rank returns the same plan, the one of the
    slowest rank's seconds, executes it bitwise the explicit call, rank 0
    alone writes the cache, and a hit on rank 0 is a hit on every rank.
"""
import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from repro.plan import PRESETS as JPRESETS
from repro.plan import autotune as j_autotune
from repro.plan import plan_nystrom as j_plan_nystrom
from repro.plan import plan_sketch as j_plan_sketch
from repro.plan import plan_stream as j_plan_stream
from repro.plan.autotune import _measurable_candidates as j_sweep
from repro_torch.core import sketch as sk
from repro_torch.core.grid import (alg1_bandwidth_words,
                                   alg2_bandwidth_words,
                                   alg2_two_grid_executable,
                                   two_grid_axis_split)
from repro_torch.kernels.sketch_matmul import (SKETCH_FWD_TILE,
                                               SKETCH_T_TILE,
                                               kernel_smem_bytes,
                                               sketch_fwd_plan)
from repro_torch.plan import (H100_GLOO, PRESET_ENTRIES, PRESETS,
                              AutotuneCache, autotune, cache_key,
                              default_timer, explain, load_sweep,
                              plan_nystrom, plan_sketch, plan_stream,
                              save_sweep, shape_bucket, sweep_records)
from repro_torch.plan import model as M
from repro_torch.plan.autotune import (CACHE_VERSION, _entry_from_plan,
                                       _measurable_candidates,
                                       _plan_from_entry, _rescore,
                                       _synthetic_input, device_bytes)
from torch_dist_helper import autotune_worker, run_workers

CPU, JCPU = PRESETS["cpu"], JPRESETS["cpu"]
H100 = PRESETS[H100_GLOO]
WORLD = 4
SEED = 3


def _tune(plan, **kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("machine", CPU)
    return autotune(plan, **kw)


def _counting(step=1e-3):
    """A timer whose n-th call returns n·step (the first candidate wins)."""
    calls = []

    def timer(fn):
        calls.append(fn)
        return step * len(calls)
    return timer, calls


def _later_wins():
    """A timer whose n-th call returns 1/n (the last candidate wins)."""
    calls = []

    def timer(fn):
        calls.append(fn)
        return 1.0 / len(calls)
    return timer


def _forbidden(fn):
    raise AssertionError("the timer ran on a hit")


def _key(p):
    return (p.variant, p.grid, p.q_grid, p.chunk_rows)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def test_cache_round_trip(tmp_path):
    path = str(tmp_path / "tune.json")
    plan = plan_sketch(64, 128, 16, P=1, machine=CPU)
    timer, calls = _counting()
    cache = AutotuneCache(path)
    tuned = _tune(plan, cache=cache, timer=timer)
    assert calls, "a miss must measure"
    assert (cache.misses, cache.hits) == (1, 0)
    assert tuned.measured_seconds == pytest.approx(1e-3)
    assert tuned.executable and tuned.variant == "cuda_fused"
    data = json.loads((tmp_path / "tune.json").read_text())
    assert data["version"] == CACHE_VERSION == 2
    assert list(data["entries"]) == [cache_key(plan, device="cpu")]
    entry = data["entries"][cache_key(plan, device="cpu")]
    assert entry["source"] == "measured" and "backend" not in entry \
        and "blocks" not in entry
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".tmp")]

    cache2 = AutotuneCache(path)
    tuned2 = _tune(plan, cache=cache2, timer=_forbidden)
    assert (cache2.hits, cache2.misses) == (1, 0)
    assert _key(tuned2) == _key(tuned)
    assert tuned2.measured_seconds == tuned.measured_seconds
    assert "(autotuned)" in explain(tuned2)

    assert cache2.pop(cache_key(plan, device="cpu")) is not None
    assert len(AutotuneCache(path)) == 0
    assert cache2.pop("absent") is None

    (tmp_path / "tune.json").write_text(json.dumps(
        {"version": -1, "entries": {"x": {}}}))
    assert len(AutotuneCache(path)) == 0
    (tmp_path / "tune.json").write_text("{not json")
    assert len(AutotuneCache(path)) == 0


def test_cache_key_and_buckets():
    plan = plan_sketch(64, 100, 16, P=1, machine=CPU)
    assert cache_key(plan, device="cpu") == "cpu/sketch/64x128x16/float32/P1"
    assert cache_key(plan, device_kind="NVIDIA_H100_80GB_HBM3") == \
        "NVIDIA_H100_80GB_HBM3/sketch/64x128x16/float32/P1"
    assert [shape_bucket(x) for x in (1, 2, 3, 64, 65, 32768)] == \
        [1, 2, 4, 64, 128, 32768]
    n = plan_nystrom(4096, 256, P=8, machine=CPU, dtype="bfloat16")
    assert cache_key(n, device="cpu") == "cpu/nystrom/4096x256/bfloat16/P8"


def test_hit_revalidates_against_exact_dims(tmp_path):
    """(16, 64, 8) and (9, 50, 8) share one bucket at P = 8, but the stored
    grid does not divide the second shape: nothing is stamped on it."""
    path = str(tmp_path / "tune.json")
    good = plan_sketch(16, 64, 8, P=8, machine=CPU)
    bad = plan_sketch(9, 50, 8, P=8, machine=CPU)
    assert cache_key(good, device="cpu") == cache_key(bad, device="cpu")
    assert good.executable and not bad.executable
    _tune(good, cache=path, timer=lambda fn: 1e-3)
    timer, calls = _counting()
    tuned_bad = _tune(bad, cache=path, timer=timer)
    assert not calls and not tuned_bad.executable
    with pytest.raises(ValueError, match="analytic-only"):
        tuned_bad.execute(np.zeros((9, 50), np.float32), device="cpu")


def test_rescored_predictions_for_the_winner(tmp_path):
    plan = plan_sketch(16, 64, 8, P=8, machine=CPU)
    tuned = _tune(plan, timer=_later_wins())
    assert tuned.grid != plan.grid
    assert tuned.predicted_words == alg1_bandwidth_words(16, 64, 8,
                                                         *tuned.grid)
    assert tuned.predicted_seconds == \
        M.alg1_cost(16, 64, 8, tuned.grid).seconds(CPU)
    path = str(tmp_path / "t.json")
    _tune(plan, cache=path, timer=_later_wins())
    hit = _tune(plan, cache=path, timer=_forbidden)
    assert _key(hit) == _key(tuned)
    assert hit.predicted_words == alg1_bandwidth_words(16, 64, 8, *hit.grid)


def test_rescore_prices_every_variant():
    s = plan_sketch(64, 128, 16, P=1, machine=CPU)
    for v, cost in (("cuda_fused", M.local_cost(64, 128, 16)),
                    ("local_torch", M.local_torch_cost(64, 128, 16))):
        got = _rescore(dataclasses.replace(s, variant=v), CPU)
        assert (got.predicted_hbm_words, got.predicted_seconds) == \
            (cost.hbm_words, cost.seconds(CPU))
    sp = plan_sketch(64, 128, 16, P=1, machine=CPU, nnz=100)
    got = _rescore(dataclasses.replace(sp, variant="local_sparse",
                                       kind="countsketch"), CPU)
    want = M.sparse_sketch_cost(64, 128, 16, 100, (1, 1, 1), "countsketch")
    assert got.predicted_flops == want.flops
    n = plan_nystrom(64, 16, P=1, machine=CPU)
    got = _rescore(dataclasses.replace(n, variant="local_torch"), CPU)
    assert got.predicted_hbm_words == \
        M.nystrom_local_torch_cost(64, 16).hbm_words
    st = plan_stream(64, 48, 8, P=1, chunk_rows=16, corange=True,
                     machine=CPU)
    got = _rescore(dataclasses.replace(st, chunk_rows=32), CPU)
    per = M.stream_update_cost(32, 48, 8, 17, (1, 1, 1), True)
    assert got.predicted_flops == 2 * per.flops


# ---------------------------------------------------------------------------
# records, presets and entries
# ---------------------------------------------------------------------------

def test_sweep_records_round_trip(tmp_path):
    plan = plan_sketch(32, 64, 8, P=1, machine=CPU)
    recs = sweep_records(plan, timer=lambda fn: 1e-3, machine=CPU,
                         device="cpu")
    assert [r["variant"] for r in recs] == ["cuda_fused", "local_torch"]
    assert all(r["seconds"] == 1e-3 for r in recs)
    assert all({"words", "messages", "flops", "hbm_words", "itemsize"}
               <= set(r) for r in recs)
    path = str(tmp_path / "sweep.json")
    save_sweep(recs, path)
    assert load_sweep(path) == recs


def test_records_and_presets(tmp_path):
    plan = plan_sketch(64, 128, 16, P=1, machine=CPU)
    recs = []
    tuned = _tune(plan, timer=lambda fn: 1e-3, records=recs, presets={})
    assert tuned.measured_seconds == 1e-3
    assert [r["variant"] for r in recs] == ["cuda_fused", "local_torch"]
    key = cache_key(plan, device="cpu")
    preset = {key: {"variant": "local_torch", "grid": None, "q_grid": None,
                    "chunk_rows": None, "source": "measured",
                    "seconds": 2e-3}}
    cache = AutotuneCache(str(tmp_path / "t.json"))
    got = _tune(plan, cache=cache, timer=_forbidden, presets=preset)
    assert got.variant == "local_torch" and got.measured_seconds == 2e-3
    assert got.predicted_seconds == \
        M.local_torch_cost(64, 128, 16).seconds(CPU)
    assert cache.get(key) == preset[key]          # the preset seeds it
    A = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (64, 128)).astype(np.float32))
    assert torch.equal(got.execute(A, seed=SEED, device="cpu"),
                       sk.sketch_reference(A, SEED, 16))


def test_shipped_presets_are_measured_h100_decisions():
    for key, entry in PRESET_ENTRIES.items():
        kind, task, dims, dtype, P = key.split("/")
        assert kind == "NVIDIA_H100_80GB_HBM3"
        assert entry["source"] == "measured" and entry["seconds"] > 0
        assert "TPU" not in key and "backend" not in entry
        assert dtype in ("float32", "bfloat16") and P.startswith("P")
        assert entry["variant"] in ("alg1", "cuda_fused", "local_torch",
                                    "alg2_no_redist", "alg2_redist",
                                    "alg2_bound_driven",
                                    "alg2_bound_driven_fused",
                                    "stream_local", "stream_sharded")
        assert task in ("sketch", "nystrom", "stream")
        assert all(shape_bucket(int(d)) == int(d) for d in dims.split("x"))


def test_shipped_presets_restore_on_the_card_entry():
    """Each shipped decision applies to the plan it was measured for, on
    the H100 entry, and is taken without a timer call."""
    plans = {"sketch": plan_sketch(32768, 32768, 512, P=1, machine=H100),
             "nystrom": plan_nystrom(32768, 512, P=1, machine=H100),
             "stream": plan_stream(32768, 32768, 512, P=1, chunk_rows=4096,
                                   corange=True, machine=H100),
             "sketch4": plan_sketch(32768, 32768, 512, P=4, machine=H100),
             "nystrom4": plan_nystrom(32768, 512, P=4, machine=H100)}
    kind = "NVIDIA_H100_80GB_HBM3"
    keys = {cache_key(p, device_kind=kind) for p in plans.values()}
    assert keys == set(PRESET_ENTRIES)
    for plan in plans.values():
        entry = PRESET_ENTRIES[cache_key(plan, device_kind=kind)]
        got = autotune(plan, timer=_forbidden, device="cpu", machine=H100,
                       device_kind=kind)
        assert _key(got) == (entry["variant"],
                             tuple(entry["grid"]) if entry["grid"] else None,
                             tuple(entry["q_grid"]) if entry["q_grid"]
                             else None, entry["chunk_rows"])
        assert got.measured_seconds == entry["seconds"]
        assert got.predicted_seconds == _rescore(got, H100).predicted_seconds


def test_entries_round_trip_and_refuse_what_the_port_lacks():
    plan = plan_sketch(64, 128, 16, P=8, machine=CPU)
    tuned = dataclasses.replace(plan, grid=(8, 1, 1), measured_seconds=1e-3)
    entry = _entry_from_plan(tuned)
    assert entry == {"variant": "alg1", "grid": [8, 1, 1], "q_grid": None,
                     "chunk_rows": None, "source": "measured",
                     "seconds": 1e-3}
    back = _plan_from_entry(plan, dict(entry, backend="pallas",
                                       blocks={"bm": 128}))
    assert _key(back) == ("alg1", (8, 1, 1), None, None)
    assert back.measured_seconds == 1e-3
    one = plan_sketch(64, 128, 16, P=1, machine=CPU)
    for variant in ("pallas_fused", "local_xla", "alg1", "no_such"):
        assert _plan_from_entry(one, {"variant": variant,
                                      "grid": None}) is None
    assert _plan_from_entry(plan, {"variant": "alg1",
                                   "grid": [4, 1, 1]}) is None
    assert _plan_from_entry(plan, {"variant": "cuda_fused"}) is None
    # a sparse decision needs a stored-sparse plan; a sparse kind has no
    # kernel draw
    assert _plan_from_entry(one, {"variant": "local_sparse"}) is None
    cs = plan_sketch(64, 128, 16, P=1, machine=CPU, kind="countsketch")
    assert _plan_from_entry(cs, {"variant": "cuda_fused"}) is None
    sp = plan_sketch(64, 128, 16, P=1, machine=CPU, nnz=100)
    got = _plan_from_entry(sp, {"variant": "local_sparse"})
    assert (got.variant, got.kind) == ("local_sparse", "countsketch")
    got = _plan_from_entry(sp, {"variant": "local_torch"})
    assert got.kind == "normal"


def test_sparse_sweep_runs_each_body_with_its_kind():
    """A plan where the sparse body won keeps the asked-for kind for the
    dense candidates it times."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((64, 128)).astype(np.float32)
    A *= rng.random(A.shape) < 0.01
    plan = plan_sketch(64, 128, 16, P=1, machine=CPU,
                       nnz=int((A != 0).sum()))
    assert plan.variant == "local_sparse" and plan.kind == "countsketch"
    cands = _measurable_candidates(plan, CPU, 3)
    assert [(c.variant, c.kind) for c in cands] == [
        ("local_sparse", "countsketch"), ("cuda_fused", "normal"),
        ("local_torch", "normal")]
    At = torch.from_numpy(A)
    for c in cands:
        c.execute(At, seed=SEED, device="cpu")
    tuned = _tune(plan, timer=_later_wins())
    assert (tuned.variant, tuned.kind) == ("local_torch", "normal")
    assert torch.equal(tuned.execute(At, seed=SEED, device="cpu"),
                       sk.sketch_reference(At, SEED, 16))


# ---------------------------------------------------------------------------
# the sweep and the winner, against the reference's on the cpu entry
# ---------------------------------------------------------------------------

SKETCH_SWEEP = [(16, 64, 8, 8), (64, 256, 16, 32), (16, 1024, 8, 64),
                (64, 512, 16, 8), (16, 48, 8, 4), (2, 48, 8, 4),
                (4096, 4096, 256, 8), (64, 512, 16, 64), (7, 7, 3, 4),
                (32768, 32768, 512, 4), (1024, 64, 8, 8)]
NYSTROM_SWEEP = [(64, 4, 8), (64, 16, 4), (32768, 512, 4), (4096, 256, 8),
                 (4096, 256, 16), (49152, 4096, 64), (64, 2, 8),
                 (30, 7, 8), (256, 16, 8), (1024, 64, 16)]
STREAM_SWEEP = [(64, 48, 8, 1, 16, False, None), (64, 48, 8, 1, 16, True, 100),
                (64, 256, 16, 8, 16, True, None),
                (16, 48, 8, 4, 4, False, None), (2, 48, 8, 4, 1, True, None),
                (32768, 32768, 512, 1, 4096, True, None),
                (32768, 32768, 512, 4, 4096, True, None),
                (64, 256, 16, 1, None, True, None),
                (64, 256, 16, 1, 16, False, 1000)]
FORCED = ["auto", "no_redist", "redist", "bound_driven",
          "bound_driven_fused"]


def _same_sweep(j, t, top_k):
    want = [_key(c) for c in j_sweep(j, JCPU, top_k)]
    got = [_key(c) for c in _measurable_candidates(t, CPU, top_k)]
    assert got == want


def _same_winner(j, t, top_k):
    want = j_autotune(j, cache=None, timer=_later_wins(), top_k=top_k,
                      presets={}, machine=JCPU)
    got = _tune(t, timer=_later_wins(), top_k=top_k, presets={})
    assert (_key(got), got.predicted_words) == \
        (_key(want), want.predicted_words)
    assert got.measured_seconds == want.measured_seconds
    if got.variant not in ("local_sparse", "stream_sparse"):
        # the reference rescores a sparse winner at its dense cost; the
        # port at its sparse one (test_rescore_prices_every_variant)
        assert got.predicted_flops == want.predicted_flops


@pytest.mark.parametrize("top_k", [1, 3, 5])
@pytest.mark.parametrize("n1,n2,r,P", SKETCH_SWEEP)
def test_sketch_sweep_matches_reference(n1, n2, r, P, top_k):
    j = j_plan_sketch(n1, n2, r, P=P, machine=JCPU)
    t = plan_sketch(n1, n2, r, P=P, machine=CPU)
    _same_sweep(j, t, top_k)
    if n1 * n2 <= 1 << 16:
        _same_winner(j, t, top_k)


@pytest.mark.parametrize("top_k", [1, 3])
@pytest.mark.parametrize("variant", FORCED)
@pytest.mark.parametrize("n,r,P", NYSTROM_SWEEP)
def test_nystrom_sweep_matches_reference(n, r, P, variant, top_k):
    try:
        j = j_plan_nystrom(n, r, P=P, machine=JCPU, variant=variant)
    except ValueError:
        with pytest.raises(ValueError):
            plan_nystrom(n, r, P=P, machine=CPU, variant=variant)
        return
    t = plan_nystrom(n, r, P=P, machine=CPU, variant=variant)
    _same_sweep(j, t, top_k)
    if n * n <= 1 << 16:
        _same_winner(j, t, top_k)


@pytest.mark.parametrize("top_k", [1, 3])
@pytest.mark.parametrize("n1,n2,r,P,k,corange,nnz", STREAM_SWEEP)
def test_stream_sweep_matches_reference(n1, n2, r, P, k, corange, nnz,
                                        top_k):
    j = j_plan_stream(n1, n2, r, P=P, chunk_rows=k, corange=corange,
                      machine=JCPU, nnz=nnz)
    t = plan_stream(n1, n2, r, P=P, chunk_rows=k, corange=corange,
                    machine=CPU, nnz=nnz)
    _same_sweep(j, t, top_k)
    if n1 * n2 <= 1 << 16:
        _same_winner(j, t, top_k)


def test_three_sweeps_list_as_the_reference():
    assert [c.grid for c in _measurable_candidates(
        plan_sketch(16, 64, 8, P=8, machine=CPU), CPU, 3)] == \
        [(8, 1, 1), (4, 2, 1), (4, 1, 2)]
    got = _measurable_candidates(plan_nystrom(64, 4, P=8, machine=CPU),
                                 CPU, 3)
    assert [c.variant for c in got] == \
        ["alg2_bound_driven_fused"] * 3 + ["alg2_bound_driven"] * 3
    assert [c.chunk_rows for c in _measurable_candidates(
        plan_stream(64, 48, 8, P=1, chunk_rows=16, machine=CPU), CPU, 3)] \
        == [8, 16, 32]


def test_one_card_sweep_is_every_executable_candidate():
    plan = plan_sketch(64, 128, 16, P=1, machine=CPU)
    assert [c.variant for c in _measurable_candidates(plan, CPU, 3)] == \
        ["cuda_fused", "local_torch"]
    n = plan_nystrom(64, 16, P=1, machine=CPU)
    assert {c.variant for c in _measurable_candidates(n, CPU, 3)} == \
        {"cuda_fused", "local_torch"}
    cs = plan_sketch(64, 128, 16, P=1, machine=CPU, kind="countsketch")
    assert [c.variant for c in _measurable_candidates(cs, CPU, 3)] == \
        ["local_torch"]


def test_two_grid_q_sweep():
    plan = plan_nystrom(64, 4, P=8, machine=CPU)
    assert plan.variant == "alg2_bound_driven_fused"
    timer, calls = _counting()
    tuned = _tune(plan, timer=timer)
    assert len(calls) >= 2 and tuned.q_grid is not None
    assert alg2_two_grid_executable(64, 4, tuned.grid, tuned.q_grid)
    want = (M.alg2_fused_cost(64, 4, tuned.grid, tuned.q_grid).words
            if tuned.variant == "alg2_bound_driven_fused"
            else alg2_bandwidth_words(64, 4, tuned.grid, tuned.q_grid))
    assert math.isclose(tuned.predicted_words, want, rel_tol=1e-12)


def test_joint_pq_sweep_and_fused_cache(tmp_path):
    plan = plan_nystrom(64, 4, P=8, machine=CPU)
    records = []
    timer, calls = _counting()
    cache = AutotuneCache(str(tmp_path / "tune.json"))
    tuned = _tune(plan, cache=cache, timer=timer, records=records)
    swept = {(rec["variant"], tuple(rec["grid"])) for rec in records
             if rec["variant"].startswith("alg2_bound_driven")}
    assert len({g for _, g in swept}) > 1
    assert any(v == "alg2_bound_driven_fused" for v, _ in swept)
    assert tuned.variant == "alg2_bound_driven_fused"
    assert two_grid_axis_split(tuned.grid, tuned.q_grid) is not None
    again = _tune(plan_nystrom(64, 4, P=8, machine=CPU), cache=cache,
                  timer=_forbidden)
    assert _key(again) == _key(tuned) and cache.hits == 1


def test_stream_chunk_sweep_executes_the_winner():
    A = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (64, 48)).astype(np.float32))
    plan = plan_stream(64, 48, 8, P=1, chunk_rows=16, corange=True,
                       machine=CPU)
    tuned = _tune(plan, timer=_later_wins())
    assert (tuned.variant, tuned.chunk_rows) == ("stream_local", 32)
    assert tuned.predicted_flops == 2 * M.stream_update_cost(
        32, 48, 8, 17, (1, 1, 1), True).flops
    st = tuned.execute(A, seed=SEED, device="cpu")
    ref = dataclasses.replace(plan, chunk_rows=32).execute(A, seed=SEED,
                                                           device="cpu")
    assert torch.equal(st.Y, ref.Y) and torch.equal(st.W, ref.W)


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------

def test_device_memory_fit_leaves_out_what_does_not_fit():
    plan = plan_sketch(64, 2048, 32, P=1, machine=CPU)
    cands = _measurable_candidates(plan, CPU, 3)
    need = {c.variant: device_bytes(c) for c in cands}
    fwd = sketch_fwd_plan(64, 32, 2048)
    assert fwd["splits"] > 1
    assert need["cuda_fused"] == (64 * 2048 * 4 + fwd["scratch_bytes"]
                                  + fwd["work_bytes"] + 64 * 32 * 4)
    assert need["local_torch"] == 64 * 2048 * 4 + 2048 * 32 * 4 + 64 * 32 * 4
    assert need["local_torch"] < need["cuda_fused"]
    small = dataclasses.replace(CPU, hbm_bytes=need["local_torch"])
    timer, calls = _counting()
    tuned = autotune(plan, timer=timer, device="cpu", machine=small)
    assert len(calls) == 1 and tuned.variant == "local_torch"
    assert any(n.startswith("cuda_fused not timed: needs "
                            f"{need['cuda_fused']} bytes of device memory")
               for n in tuned.notes)
    assert "autotune: cuda_fused not timed" in explain(tuned)
    none = dataclasses.replace(CPU, hbm_bytes=1024)
    timer, calls = _counting()
    left = autotune(plan, timer=timer, device="cpu", machine=none)
    assert not calls and left.variant == plan.variant
    assert left.measured_seconds is None and len(left.notes) == 3


def test_shared_memory_fit_leaves_out_what_does_not_fit():
    smem = kernel_smem_bytes()
    assert smem["sketch_fwd_gemm_kernel"] == (2 * 16 * 2 * SKETCH_FWD_TILE
                                              * 4, 0)
    assert smem["sketch_t_gemm_kernel"] == (2 * 8 * 2 * SKETCH_T_TILE * 4, 0)
    assert smem["sketch_fwd_narrow_kernel<16>"] == (0, 4 * 16 * 1540)
    assert all(sum(b) <= H100.smem_bytes for b in smem.values())
    plan = plan_sketch(64, 128, 32, P=1, machine=CPU)
    tight = dataclasses.replace(CPU, smem_bytes=32767)
    timer, calls = _counting()
    tuned = autotune(plan, timer=timer, device="cpu", machine=tight)
    assert len(calls) == 1 and tuned.variant == "local_torch"
    assert any("sketch_fwd_gemm_kernel needs 32768 bytes of shared memory"
               in n for n in tuned.notes)


# ---------------------------------------------------------------------------
# timing and the synthetic input
# ---------------------------------------------------------------------------

def test_default_timer_on_the_cpu():
    calls = []
    secs = default_timer(lambda: calls.append(1), warmup=2, iters=5,
                         device="cpu")
    assert len(calls) == 7 and secs >= 0.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default_timer(lambda: None)


def test_synthetic_input_is_seeded_normal_data():
    plan = plan_sketch(300, 20000, 8, P=1, machine=CPU)
    A = _synthetic_input(plan, torch.device("cpu"))
    assert A.shape == (300, 20000) and A.dtype == torch.float32
    assert torch.equal(A, _synthetic_input(plan, torch.device("cpu")))
    assert abs(float(A.mean())) < 0.01 and abs(float(A.std()) - 1) < 0.01
    assert bool((A != 0).all())
    rows = (1 << 22) // 20000                 # chunk 1: the last 91 rows
    g = torch.Generator().manual_seed(1)
    assert torch.equal(A[rows:], torch.randn((300 - rows, 20000),
                                             generator=g))
    n = _synthetic_input(plan_nystrom(64, 8, P=1, machine=CPU,
                                      dtype="bfloat16"), "cpu")
    assert n.shape == (64, 64) and n.dtype == torch.bfloat16


def test_real_timer_run_executes_bitwise():
    n1, n2, r = 32, 64, 8
    A = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (n1, n2)).astype(np.float32))
    plan = plan_sketch(n1, n2, r, P=1, machine=CPU)
    tuned = autotune(plan, device="cpu", machine=CPU, presets={})
    assert tuned.measured_seconds is not None and tuned.measured_seconds > 0
    assert tuned.variant in ("cuda_fused", "local_torch")
    assert torch.equal(tuned.execute(A, seed=9, device="cpu"),
                       sk.sketch_reference(A, 9, r))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the CPU-only refusal needs a host without CUDA")
    plan = plan_sketch(32, 64, 8, P=1, machine=CPU)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune(plan, timer=lambda fn: 1e-3, machine=CPU, presets={})


# ---------------------------------------------------------------------------
# four gloo ranks, spawned once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dist_inputs():
    rng = np.random.default_rng(7)
    A = rng.standard_normal((16, 48)).astype(np.float32)
    X = rng.standard_normal((64, 8))
    return A, (X @ X.T).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(dist_inputs, tmp_path_factory):
    A, S = dist_inputs
    spec = {"seed": SEED, "dir": str(tmp_path_factory.mktemp("tune")),
            "sketch": (A, 8), "S": S, "s_r": 16, "stream": (A, 8, 4),
            "preset_grid": (2, 1, 2)}
    return run_workers(autotune_worker, WORLD, spec)


def _plans():
    return {"sketch": plan_sketch(16, 48, 8, P=WORLD, machine=CPU),
            "nystrom": plan_nystrom(64, 16, P=WORLD, machine=CPU),
            "stream": plan_stream(16, 48, 8, P=WORLD, chunk_rows=4,
                                  corange=True, machine=CPU)}


@pytest.mark.parametrize("task", ["sketch", "nystrom", "stream"])
def test_ranks_agree_on_the_slowest_ranks_winner(ranks, task):
    plan = _plans()[task]
    sweep = _measurable_candidates(plan, CPU, 3)
    slowest = [3.0 - 0.1 * i for i in range(len(sweep))]
    assert len(sweep) >= 3
    first = ranks[0][task]
    for rank, res in enumerate(r[task] for r in ranks):
        # each rank saw its own seconds; alone it would pick another
        assert res["local"] == [3.0 - 0.1 * i if i % WORLD == rank else 1.0
                                for i in range(len(sweep))]
        assert [rec[:4] for rec in res["records"]] == [_key(c)
                                                       for c in sweep]
        assert [rec[4] for rec in res["records"]] == pytest.approx(slowest)
        assert res["tuned"] == first["tuned"]
        assert res["bitwise"]
    winner = sweep[-1]
    assert first["tuned"][:4] == _key(winner)
    assert first["tuned"][4] == _rescore(winner, CPU).predicted_words
    assert first["tuned"][5] == pytest.approx(slowest[-1])


@pytest.mark.parametrize("task", ["sketch", "nystrom", "stream"])
def test_rank_zero_alone_writes_and_a_hit_is_a_hit_everywhere(ranks, task):
    for res in (r[task] for r in ranks):
        assert res["files"] == [True] + [False] * (WORLD - 1)
        assert res["again"][:5] == res["tuned"][:5]
        assert res["again"][5] == pytest.approx(res["tuned"][5])
        assert res["counts"] == (0, 1, 1, 0)


def test_rank_zero_alone_reads_the_presets(ranks):
    for res in (r["preset"] for r in ranks):
        assert res["plan"][:4] == ("alg1", (2, 1, 2), None, None)
        assert res["plan"][4] == alg1_bandwidth_words(16, 48, 8, 2, 1, 2)
        assert res["bitwise"]
