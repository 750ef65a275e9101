"""The port's cost model and machine model (``repro_torch.plan``) against
the reference's (``repro.plan``), on the CPU.

Words, messages and FLOPs of every ported cost function must EQUAL the
reference's (the same arithmetic in the same order), and so must
``Cost.seconds`` / ``Cost.bottleneck`` and ``calibrate_machine_model`` on
the ``cpu`` entry.  Device-memory words price the port's kernels (their
Omega scratch and split-K work buffer, ``sketch_fwd_plan`` /
``sketch_t_plan`` / ``gemm_plan``) and are held to the port's own formula.
The shapes are those of ``tests/test_plan.py`` (powers of two),
``tests/test_torch_grid.py``'s and ``tests/test_service_scale.py``'s.
"""
import dataclasses
import itertools
import json
import math

import numpy as np
import pytest
import torch

from repro.plan import model as jmodel
from repro.plan.autotune import CACHE_VERSION as J_CACHE_VERSION
from repro.plan.autotune import calibrate_machine_model as j_calibrate
from repro.plan.autotune import save_sweep as j_save_sweep
from repro_torch import plan as tplan
from repro_torch.core.grid import factorizations_3d
from repro_torch.kernels.sketch_matmul import (gemm_plan, sketch_fwd_plan,
                                               sketch_t_plan)
from repro_torch.plan import autotune as tautotune
from repro_torch.plan import model as tmodel
from repro_torch.serve import make_ingest_queue
from repro_torch.stream import SketchService, StreamConfig
from repro_torch.stream.state import snap_bucket

CPU = tmodel.PRESETS["cpu"]
H100 = tmodel.PRESETS[tmodel.H100_GLOO]

# tests/test_plan.py's powers of two, tests/test_torch_grid.py's shapes
# and the card's main path
MATMUL_SHAPES = sorted({(2 ** a, 2 ** b, 2 ** c)
                        for a in (0, 3, 6) for b in (2, 5, 8)
                        for c in (0, 2, 5) if 2 ** c < 2 ** b} | {
    (100, 200, 10), (64, 256, 16), (16, 1024, 8), (4096, 4096, 256),
    (32768, 32768, 512), (2000, 1999, 7), (3, 2000, 1500), (17, 33, 5),
    (50000, 50000, 500), (10 ** 6, 10 ** 6, 1000)})
P_VALUES = (1, 2, 4, 8, 16, 64)
NYSTROM_SHAPES = [(16, 2), (64, 8), (256, 32), (512, 64), (300, 20),
                  (4096, 256), (8192, 128), (32768, 512), (32768, 2),
                  (50000, 5000)]
# (k, n2, r, l): tests/test_service_scale.py's, the card's serving lane
# and the card's streaming slab
STREAM_SHAPES = [(3, 256, 16, 33), (32, 256, 16, 33), (1, 64, 8, 17),
                 (17, 64, 8, 17), (256, 8192, 128, 257),
                 (4096, 32768, 512, 1025), (5, 96, 8, 16)]
SPARSE_KINDS = ("countsketch", "rowsample", "normal")
GRAD_SHAPES = [(256, 64, 8), (64, 256, 16), (256000, 2304, 8),
               (2304, 9216, 8), (33, 17, 40), (4096, 4096, 64),
               (1, 8, 4)]


def _triple(c):
    return (c.words, c.messages, c.flops)


# ---------------------------------------------------------------------------
# words, messages and FLOPs: the reference's, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MATMUL_SHAPES, ids=str)
def test_sketch_costs_equal_the_reference(shape):
    n1, n2, r = shape
    assert _triple(tmodel.local_cost(n1, n2, r)) == _triple(
        jmodel.local_cost(n1, n2, r))
    for P in P_VALUES:
        for grid in factorizations_3d(P):
            for fn in ("alg1_cost", "alg1_communicating_cost"):
                t = getattr(tmodel, fn)(n1, n2, r, grid)
                j = getattr(jmodel, fn)(n1, n2, r, grid)
                assert _triple(t) == _triple(j), (fn, grid)


@pytest.mark.parametrize("shape", NYSTROM_SHAPES, ids=str)
def test_nystrom_costs_equal_the_reference(shape):
    n, r = shape
    t, j = tmodel.nystrom_local_cost(n, r), jmodel.nystrom_local_cost(n, r)
    assert _triple(t) == _triple(j)
    for P in (1, 2, 4, 8):
        facs = list(factorizations_3d(P))
        for p, q in itertools.product(facs, facs):
            for fn in ("alg2_cost", "alg2_fused_cost"):
                assert _triple(getattr(tmodel, fn)(n, r, p, q)) == _triple(
                    getattr(jmodel, fn)(n, r, p, q)), (fn, p, q)


@pytest.mark.parametrize("shape", STREAM_SHAPES, ids=str)
@pytest.mark.parametrize("corange", [True, False])
def test_stream_update_cost_equals_the_reference(shape, corange):
    k, n2, r, l = shape
    for P in (1, 2, 4, 8):
        for grid in factorizations_3d(P):
            t = tmodel.stream_update_cost(k, n2, r, l, grid=grid,
                                          corange=corange)
            j = jmodel.stream_update_cost(k, n2, r, l, grid=grid,
                                          corange=corange)
            assert _triple(t) == _triple(j), grid


@pytest.mark.parametrize("kind", SPARSE_KINDS)
@pytest.mark.parametrize("nnz", [0, 1, 100, 139264, 2.5e6])
def test_sparse_costs_equal_the_reference_in_all_four_counts(kind, nnz):
    """S1's gathers are L2 traffic, so even ``hbm_words`` is the
    reference's."""
    assert tmodel.SPARSE_SCATTER_PENALTY == jmodel.SPARSE_SCATTER_PENALTY
    for n1, n2, r in MATMUL_SHAPES[:12] + [(32768, 32768, 512)]:
        for grid in ((1, 1, 1), (2, 2, 1), (1, 2, 2), (1, 1, 4), (2, 1, 2)):
            t = tmodel.sparse_sketch_cost(n1, n2, r, nnz, grid=grid,
                                          kind=kind)
            j = jmodel.sparse_sketch_cost(n1, n2, r, nnz, grid=grid,
                                          kind=kind)
            assert dataclasses.astuple(t) == (
                j.words, j.flops, j.messages, j.hbm_words), grid
    for k, n2, r, l in STREAM_SHAPES:
        for grid in ((1, 1, 1), (2, 2, 1), (1, 2, 2), (4, 1, 1)):
            for corange in (True, False):
                t = tmodel.sparse_stream_update_cost(
                    k, n2, r, l, nnz, grid=grid, corange=corange, kind=kind)
                j = jmodel.sparse_stream_update_cost(
                    k, n2, r, l, nnz, grid=grid, corange=corange, kind=kind)
                assert dataclasses.astuple(t) == (
                    j.words, j.flops, j.messages, j.hbm_words), grid
    assert tmodel.sparse_payload_words(nnz) == jmodel.sparse_payload_words(
        nnz)


@pytest.mark.parametrize("shape", GRAD_SHAPES, ids=str)
@pytest.mark.parametrize("world", [1, 2, 3, 8, 64])
def test_grad_costs_equal_the_reference(shape, world):
    m, n, r = shape
    assert _triple(tmodel.grad_allreduce_cost(m, n, world)) == _triple(
        jmodel.grad_allreduce_cost(m, n, world))
    assert _triple(tmodel.grad_compress_cost(m, n, r, world)) == _triple(
        jmodel.grad_compress_cost(m, n, r, world))


# ---------------------------------------------------------------------------
# seconds and bottleneck: the reference's formula
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MATMUL_SHAPES[::3], ids=str)
def test_seconds_and_bottleneck_equal_the_reference_on_cpu(shape):
    n1, n2, r = shape
    jcpu = jmodel.PRESETS["cpu"]
    for f in ("alpha", "byte_bw", "flop_rate", "hbm_bw", "hbm_bytes",
              "dispatch_overhead"):
        assert getattr(CPU, f) == getattr(jcpu, f), f
    assert CPU.smem_bytes == jcpu.vmem_bytes
    for P in (1, 4, 16):
        for grid in factorizations_3d(P):
            t = tmodel.alg1_cost(n1, n2, r, grid)
            j = jmodel.Cost(words=t.words, messages=t.messages,
                            flops=t.flops, hbm_words=t.hbm_words)
            for isz in (2, 4):
                assert t.seconds(CPU, isz) == j.seconds(jcpu, isz)
                assert t.bottleneck(CPU, isz) == j.bottleneck(jcpu, isz)


def test_seconds_formula():
    c = tmodel.Cost(words=1e6, flops=4e9, messages=3.0, hbm_words=2e8)
    t_net, t_flop, t_mem = 4e6 / H100.byte_bw, 4e9 / 67e12, 8e8 / 3.35e12
    assert c.seconds(H100) == max(t_flop, t_mem) + t_net + 3 * H100.alpha
    assert c.bottleneck(H100) == max(
        (("network", t_net), ("compute", t_flop), ("memory", t_mem)),
        key=lambda kv: kv[1])[0]
    assert tmodel.Cost(words=0.0, flops=1.0).bottleneck(H100) == "compute"


# ---------------------------------------------------------------------------
# device-memory words: the port's kernels, scratch and work buffers
# ---------------------------------------------------------------------------

def _fwd(m, n, K):
    if m == 0 or n == 0:
        return 0
    p = sketch_fwd_plan(m, n, K)
    return 2 * (p["scratch_bytes"] + p["work_bytes"]) // 4


def _t(m, n, K):
    if m == 0 or n == 0:
        return 0
    p = sketch_t_plan(m, n, K)
    return 2 * (p["scratch_bytes"] + p["work_bytes"]) // 4


def test_sketch_t_plan_names_the_call():
    assert sketch_t_plan(256, 256, 32768) == {
        "splits": 64, "scratch_bytes": 32768 * 256 * 4,
        "work_bytes": 16 * 2 ** 20}
    assert sketch_t_plan(2, 1, 16384) == {
        "splits": 32, "scratch_bytes": 16384 * 4 * 4, "work_bytes": 256}
    # a full grid of tiles: no split, no work buffer
    assert sketch_t_plan(1025, 32768, 4096)["work_bytes"] == 0
    assert sketch_fwd_plan(32768, 128, 32768)["work_bytes"] == 2 ** 30


def test_alg1_prices_the_split_work_buffer():
    """(1,1,4): ``sketch_fwd`` of 32768 x 32768 -> 128 takes 64 splits and
    a 1 GiB work buffer, written and read on top of the 1,086,324,736
    words of the panel, the Omega scratch and the partial."""
    c = tmodel.alg1_cost(32768, 32768, 512, (1, 1, 4))
    assert c.hbm_words == 1_623_195_648
    assert c.hbm_words - 2 * 2 ** 30 // 4 == 1_086_324_736
    # wider than one tile: no split, no work buffer
    c2 = tmodel.alg1_cost(32768, 32768, 512, (4, 1, 1))
    assert c2.hbm_words == 8192 * 32768 + 2 * 32768 * 512 + 8192 * 512


def test_alg2_prices_the_sketch_t_work_buffer():
    n, r, p, q = 32768, 512, (4, 1, 1), (1, 2, 2)
    c = tmodel.alg2_cost(n, r, p, q)
    stage2 = n * r / 2 + 2 * n * 256 + 2 * 4_194_304 + 256 * 256
    assert c.hbm_words == tmodel.alg1_cost(n, n, r, p).hbm_words + stage2
    assert tmodel.alg2_fused_cost(n, r, p, q).hbm_words == c.hbm_words


@pytest.mark.parametrize("shape", STREAM_SHAPES, ids=str)
def test_stream_update_prices_both_work_buffers(shape):
    k, n2, r, l = shape
    for grid in ((1, 1, 1), (2, 2, 1), (1, 2, 2), (4, 1, 1)):
        p1, p2, p3 = grid
        cols = n2 / (p2 * p3)
        c = tmodel.stream_update_cost(k, n2, r, l, grid=grid)
        assert c.hbm_words == (
            k * n2 / p2 + _fwd(k, r // p3, n2 // p2) + 4.0 * k * r / p3
            + k * cols + _t(l, n2 // (p2 * p3), k) + 2.0 * l * cols), grid
        c0 = tmodel.stream_update_cost(k, n2, r, l, grid=grid, corange=False)
        assert c0.hbm_words == (k * n2 / p2 + _fwd(k, r // p3, n2 // p2)
                                + 4.0 * k * r / p3)
    # a serving lane: 16 splits, a 2 MiB work buffer at k = 256
    lane = tmodel.stream_update_cost(256, 8192, 128, 257)
    assert _fwd(256, 128, 8192) == 2 * (8192 * 128 * 4 + 2 * 2 ** 20) // 4
    assert lane.hbm_words == (256 * 8192 + _fwd(256, 128, 8192)
                              + 4 * 256 * 128 + 256 * 8192
                              + 2 * 260 * 256 + 2 * 257 * 8192)


@pytest.mark.parametrize("shape", MATMUL_SHAPES, ids=str)
def test_local_costs_price_one_call_each(shape):
    m, k, n = shape
    assert tmodel.hbm_roofline_words(m, k, n) == m * k + _fwd(m, n, k) + m * n
    assert tmodel.hbm_roofline_words(m, k, n, accumulate=True) == (
        m * k + _fwd(m, n, k) + 2 * m * n)
    assert tmodel.local_cost(m, k, n).hbm_words == (
        tmodel.hbm_roofline_words(m, k, n))


@pytest.mark.parametrize("shape", NYSTROM_SHAPES, ids=str)
def test_nystrom_local_cost_prices_both_calls(shape):
    n, r = shape
    c = tmodel.nystrom_local_cost(n, r)
    assert c.hbm_words == (n * n + _fwd(n, r, n) + n * r      # sketch_fwd
                           + n * r + _t(r, r, n) + r * r)     # sketch_t


@pytest.mark.parametrize("shape", GRAD_SHAPES, ids=str)
def test_grad_costs_price_the_exchange(shape):
    m, n, r = shape
    rr = min(r, m, n)

    def work(M, N, K):
        return 2 * gemm_plan(M, N, K)["work_bytes"] // 4
    want = (2.5 * m * n                                      # M = G + E
            + m * n + _fwd(m, rr, n) + m * rr + 2 * m * rr   # sketch, QR
            + m * rr + m * n + rr * n + work(rr, n, m)       # (a)
            + m * rr + rr * n + 0.5 * m * n + work(m, n, rr)  # (b) bf16
            + m * rr + rr * n + 2 * m * n + work(m, n, rr))  # (c)
    for world in (1, 2, 8):
        c = tmodel.grad_compress_cost(m, n, r, world)
        assert c.hbm_words == want
        assert c.messages == (2 * math.log2(world) if world > 1 else 0.0)
        raw = tmodel.grad_allreduce_cost(m, n, world)
        assert raw.hbm_words == (2.0 * m * n if world > 1 else 0.0)
    # the embed leaf's call (a) is skinny and split: its work is priced
    if (m, n, r) == (256000, 2304, 8):
        assert gemm_plan(8, 2304, 256000)["work_bytes"] > 0


# ---------------------------------------------------------------------------
# calibration and the sweep JSON
# ---------------------------------------------------------------------------

def _records(machine, grids=((8, 1, 1), (2, 2, 2), (1, 4, 2), (4, 2, 1),
                             (1, 1, 8))):
    recs = []
    for grid in grids:
        c = tmodel.alg1_cost(64, 128, 16, grid)
        recs.append({"words": c.words, "messages": c.messages,
                     "flops": c.flops, "hbm_words": c.hbm_words,
                     "itemsize": 4, "seconds": c.seconds(machine, 4)})
    return recs


def test_calibrate_recovers_alpha_beta():
    true = dataclasses.replace(CPU, alpha=3e-5, byte_bw=2e9)
    fit = tplan.calibrate_machine_model(_records(true), base=CPU)
    assert abs(fit.alpha - true.alpha) / true.alpha < 0.05
    assert abs(fit.byte_bw - true.byte_bw) / true.byte_bw < 0.05
    assert fit.name == "cpu_calibrated"
    assert (fit.flop_rate, fit.hbm_bw) == (CPU.flop_rate, CPU.hbm_bw)


def test_calibrate_keeps_the_base_on_zero_word_records():
    recs = [{"words": 0.0, "messages": 0.0, "flops": 1e6,
             "hbm_words": 1e4, "itemsize": 4, "seconds": 1e-4}]
    fit = tplan.calibrate_machine_model(recs, base=CPU, name="x")
    assert (fit.alpha, fit.byte_bw, fit.name) == (CPU.alpha, CPU.byte_bw,
                                                  "x")
    assert tplan.calibrate_machine_model([], base=H100).byte_bw == (
        H100.byte_bw)


@pytest.mark.parametrize("seed", range(4))
def test_calibrate_equals_the_reference_bit_for_bit(seed):
    """The same records and the ``cpu`` entry: the same fit, bit for bit
    (numpy's lstsq on the same rows), clamped values included."""
    rng = np.random.default_rng(seed)
    recs = _records(dataclasses.replace(CPU, alpha=1e-4, byte_bw=1e9))
    for rec in recs:
        rec["seconds"] *= float(rng.uniform(0.5, 2.0))
    recs.append({"words": 10.0, "messages": 0.0, "flops": 0.0,
                 "hbm_words": 0.0, "itemsize": 2, "seconds": 1e-9})
    t = tplan.calibrate_machine_model(recs, base=CPU)
    j = j_calibrate(recs, base=jmodel.PRESETS["cpu"])
    assert (t.alpha, t.byte_bw, t.name) == (j.alpha, j.byte_bw, j.name)


def test_sweep_round_trip(tmp_path):
    recs = _records(H100)
    recs[0]["device_kind"] = "NVIDIA_H100_80GB_HBM3"
    path = tmp_path / "sweep.json"
    tplan.save_sweep(recs, path)
    assert tplan.load_sweep(path) == recs
    data = json.loads(path.read_text())
    assert data["version"] == J_CACHE_VERSION
    j_save_sweep(recs, str(tmp_path / "ref.json"))
    assert tplan.load_sweep(tmp_path / "ref.json") == recs


def test_the_h100_entry_is_the_fit_of_the_committed_records():
    """``alpha`` and ``byte_bw`` of the H100 entry are the fit of the
    committed card records, not the base's: a base whose network terms
    are NaN gives the same values, so neither was clamped."""
    recs = tplan.load_sweep(tautotune.H100_SWEEP)
    assert recs and all(r["device_kind"] == "NVIDIA_H100_80GB_HBM3"
                        and r["power_limit"].endswith(" W") for r in recs)
    assert sum(r["words"] > 0 for r in recs) >= 10
    nan = dataclasses.replace(H100, alpha=math.nan, byte_bw=math.nan)
    fit = tplan.calibrate_machine_model(recs, base=nan)
    assert (fit.alpha, fit.byte_bw) == (H100.alpha, H100.byte_bw)
    assert fit.alpha > 0 and fit.byte_bw > 0
    # the local floor of every record is below its measured seconds
    for r in recs:
        assert max(r["flops"] / H100.flop_rate,
                   r["hbm_words"] * r["itemsize"] / H100.hbm_bw) \
            <= r["seconds"], r["call"]


def test_the_machine_entries_inherit_no_tpu_number():
    tpu = [m for k, m in jmodel.PRESETS.items() if k.startswith("tpu")]
    assert set(tmodel.PRESETS) == {"cpu", tmodel.H100_GLOO}
    for f in ("byte_bw", "flop_rate", "hbm_bw", "hbm_bytes"):
        assert all(getattr(H100, f) != getattr(m, f) for m in tpu), f
    assert (H100.flop_rate, H100.hbm_bw) == (67e12, 3.35e12)
    assert "gloo" in H100.name and "nvlink" not in H100.name.lower()


# ---------------------------------------------------------------------------
# probe_machine and device_kind_tag
# ---------------------------------------------------------------------------

def test_probe_machine_on_the_cpu():
    assert tplan.probe_machine("cpu") == CPU
    assert tplan.device_kind_tag("cpu") == "cpu"
    if not torch.cuda.is_available():
        assert tplan.probe_machine() == CPU
        assert tplan.device_kind_tag() == "cpu"


@pytest.mark.parametrize("name", ["NVIDIA H100 80GB HBM3",
                                  "NVIDIA H100 PCIe"])
def test_probe_machine_gives_an_h100_the_entry(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert tplan.probe_machine("cuda") is H100
    assert tplan.probe_machine(torch.device("cuda", 0)) is H100
    assert tplan.device_kind_tag("cuda") == name.replace(" ", "_")


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB",
                                  "NVIDIA GeForce RTX 4090"])
def test_probe_machine_refuses_another_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    with pytest.raises(ValueError, match="machine="):
        tplan.probe_machine("cuda")
    with pytest.raises(ValueError, match=name):
        tplan.probe_machine("cuda")
    assert tplan.device_kind_tag("cuda") == name.replace(" ", "_")


# ---------------------------------------------------------------------------
# bucket edges
# ---------------------------------------------------------------------------

def _total(ks, edges, machine, n2=256, r=16, l=33):
    groups = {}
    for k in ks:
        groups.setdefault(snap_bucket(k, edges), []).append(k)
    return sum(tmodel.ragged_bucket_cost(g, kb, n2, r, l, machine=machine)
               for kb, g in groups.items())


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("machine", ["cpu", tmodel.H100_GLOO])
def test_choose_bucket_edges_covers_and_is_optimal(seed, machine):
    """Every height fits its bucket, [1] stays its own bucket, and the DP's
    total is no larger than that of any other set of edges drawn from the
    sample's heights (all of them, by brute force)."""
    m = tmodel.PRESETS[machine]
    rng = np.random.default_rng(seed)
    ks = [int(rng.integers(1, 65)) for _ in range(int(rng.integers(1, 9)))]
    edges = tplan.choose_bucket_edges(ks, 256, 16, machine=m)
    assert edges == sorted(set(edges)) and edges[-1] == max(ks)
    assert all(snap_bucket(k, edges) >= k for k in ks)
    assert (1 in edges) == (1 in ks)
    best = _total(ks, edges, m)
    rest = sorted(set(ks) - {1, max(ks)})
    for n in range(len(rest) + 1):
        for sub in itertools.combinations(rest, n):
            other = sorted(set(sub) | {max(ks)} | ({1} & set(ks)))
            assert best <= _total(ks, other, m) + 1e-15, other


def test_choose_bucket_edges_limits():
    ks = [3, 3, 7, 8, 8, 17, 31, 32]
    free = dataclasses.replace(CPU, dispatch_overhead=0.0)
    assert tplan.choose_bucket_edges(ks, 256, 16, machine=free) == sorted(
        set(ks))
    dominant = dataclasses.replace(H100, dispatch_overhead=1e3)
    assert tplan.choose_bucket_edges(ks, 256, 16, machine=dominant) == [32]
    assert tplan.choose_bucket_edges([], 256, 16, machine=CPU) == []
    assert tplan.choose_bucket_edges([1, 1, 4, 9], 512, 32,
                                     machine=dominant) == [1, 9]
    # the lane price is stream_update_cost's at the bucket's top
    assert tmodel.ragged_bucket_cost([3, 5], 8, 256, 16, 33, machine=H100) \
        == H100.dispatch_overhead + 2 * tmodel.stream_update_cost(
            8, 256, 16, 33).seconds(H100)


# ---------------------------------------------------------------------------
# make_ingest_queue(bucket_edges="auto")
# ---------------------------------------------------------------------------

def _cfg(seed):
    return StreamConfig(n1=96, n2=64, r=8, seed=seed)


def test_auto_edges_are_the_planners_and_fall_back_to_pow2():
    svc = SketchService(device="cpu")
    ks = [1, 3, 3, 7, 12, 12, 30, 31, 32]
    q = make_ingest_queue(svc, expected_ks=ks)       # no stream open yet
    assert q.bucket_edges is None
    q.shutdown()
    svc.open(_cfg(1))
    q = make_ingest_queue(svc, expected_ks=ks)
    want = tplan.choose_bucket_edges(ks, 64, 8, _cfg(1).sketch_l,
                                     machine=CPU)
    assert list(q.bucket_edges) == want and want[0] == 1
    q.shutdown()
    for kw in ({}, {"expected_ks": []}, {"bucket_edges": None,
                                         "expected_ks": ks}):
        q = make_ingest_queue(svc, **kw)
        assert q.bucket_edges is None, kw
        q.shutdown()
    q = make_ingest_queue(svc, bucket_edges=[4, 2, 64], expected_ks=ks)
    assert q.bucket_edges == (2, 4, 64)
    q.shutdown()


@pytest.mark.parametrize("seed", range(3))
def test_auto_edge_lanes_are_bitwise_their_solo_updates(seed):
    rng = np.random.default_rng(seed)
    svc, solo = SketchService(device="cpu"), SketchService(device="cpu")
    cfgs = [_cfg(200 + i) for i in range(6)]
    sids = [svc.open(c) for c in cfgs]
    rids = [solo.open(c) for c in cfgs]
    items = []
    for i in range(len(cfgs)):
        for _ in range(2):
            k = int(rng.integers(1, 33))
            items.append((i, rng.standard_normal((k, 64)).astype(
                np.float32), int(rng.integers(0, 96 - k + 1))))
    q = make_ingest_queue(svc, window=8,
                          expected_ks=[H.shape[0] for _, H, _ in items])
    assert q.bucket_edges is not None
    for i, H, row0 in items:
        q.submit(sids[i], H, row0)
    q.flush(raise_errors=True)
    st = q.stats()
    q.shutdown()
    assert st["applied"] == len(items) and st["retries"] == 0
    for i, H, row0 in items:
        solo.update(rids[i], H, row0=row0)
    for s, r in zip(sids, rids):
        for a, b in ((svc.sketch(s), solo.sketch(r)),
                     (svc.corange(s), solo.corange(r))):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
