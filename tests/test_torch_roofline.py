"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``), and its counts against the cost model, on the CPU.

  (1) ``RooflineTerms``, ``to_dict``, ``t_bound``, ``format_table`` and
      ``save_json`` equal the reference's on the same numbers (the port's
      terms priced on the reference's bf16 peak for ``roofline_fraction``);
  (2) the kernels' counted FLOPs equal exactly the reference's
      ``hlo_cost.analyze`` FLOPs of its ``backend="jnp"`` call;
  (3) the kernels' counted bytes equal ``plan.model``'s prices;
  (4) the dispatch mode: GEMM FLOPs, views at 0 bytes, no double count
      inside a kernel's plain path;
  (5) ``analyze_call`` equals ``analyze_cost`` on the one-card sketch,
      Nystrom and stream bodies (the stream's one named difference);
  (6) four gloo ranks: Alg. 1's fleet collective bytes;
  (7) ``model_flops``, ``count_params_split``, ``count_active_params``;
  (8) ``analyze_call`` needs the card unless asked for the CPU.

FLOPs and words are integers held exactly; times are their quotients by
the same rates on both sides.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import torch_dist_helper as tdh
from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig
from repro.core.grid import alg1_bandwidth_words
from repro.kernels import local as jlocal
from repro.models import api as japi
from repro.roofline import analysis as janalysis
from repro.roofline import hlo_cost
from repro_torch.configs import get_config
from repro_torch.core.sketch import sketch_reference
from repro_torch.core.nystrom import nystrom_reference
from repro_torch.kernels import local, ops
from repro_torch.models import (count_active_params, count_params_split,
                                model_flops)
from repro_torch.plan import model as tmodel
from repro_torch.roofline import (H100, RooflineTerms, WorkCounts,
                                  analyze_call, analyze_cost, analyze_counts,
                                  counting, format_table, h100_rates,
                                  save_json)
from repro_torch.roofline import counts as C
from repro_torch.stream import StreamConfig, StreamingSketch

F32, BF16 = torch.float32, torch.bfloat16


def _rand(*shape, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


# -- (1) the terms, their table and their JSON -------------------------------

TERMS = [dict(name="alg1 (2,2,1)", chips=4, hlo_flops=8.0e12,
              hlo_bytes=3.0e10, collective_bytes=1.2e9, t_compute=0.0101,
              t_memory=0.0022, t_collective=0.75, bottleneck="collective",
              model_flops=8.0e12, useful_ratio=1.0,
              collective_counts={"all_gather": 1},
              collective_by_kind={"all_gather": 1.2e9}),
         dict(name="small", chips=1, hlo_flops=262144.0, hlo_bytes=36864.0,
              collective_bytes=0.0, t_compute=3.9e-9, t_memory=1.1e-8,
              t_collective=0.0, bottleneck="memory", model_flops=131072.0,
              useful_ratio=0.5, notes="x"),
         dict(name="no model", chips=2, hlo_flops=1e6, hlo_bytes=1e6,
              collective_bytes=1e3, t_compute=0.5, t_memory=0.25,
              t_collective=0.125, bottleneck="compute")]


def test_terms_table_and_json_equal_the_reference(tmp_path):
    peak = janalysis.PEAK_FLOPS_BF16
    ref = [janalysis.RooflineTerms(**t) for t in TERMS]
    mine = [RooflineTerms(**t, peak_flops=peak) for t in TERMS]
    for r, m in zip(ref, mine):
        assert m.t_bound == r.t_bound
        assert m.roofline_fraction == r.roofline_fraction
        d = m.to_dict()
        assert {k: d[k] for k in r.to_dict()} == r.to_dict()
        assert d["peak_flops"] == peak and d["hbm_bw"] is None
    assert format_table(mine) == janalysis.format_table(ref)
    keys = ("name", "t_bound", "bottleneck", "roofline_fraction")
    assert format_table(mine, keys) == janalysis.format_table(ref, keys)
    save_json(mine, tmp_path / "mine.json")
    janalysis.save_json(ref, tmp_path / "ref.json")
    got = json.loads((tmp_path / "mine.json").read_text())
    want = json.loads((tmp_path / "ref.json").read_text())
    assert [{k: g[k] for k in w} for g, w in zip(got, want)] == want


def test_rates_are_the_cards_and_no_tpu_constant_is_exported():
    import repro_torch.roofline as rl
    rates = h100_rates()
    machine = tmodel.PRESETS[tmodel.H100_GLOO]
    assert rates.card == H100["card"] == "NVIDIA H100 80GB HBM3"
    assert rates.power_limit_w == 700.0
    assert dict(rates.peak_flops) == {"float32": machine.flop_rate,
                                      "bfloat16": 989.4e12}
    assert (rates.hbm_bw, rates.link_bw) == (machine.hbm_bw, machine.byte_bw)
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_LINK_BW"):
        assert not hasattr(rl, name)
    with pytest.raises(ValueError, match="no float64 peak"):
        rates.peak("float64")
    with pytest.raises(ValueError, match="peak_flops"):
        RooflineTerms(**TERMS[0]).roofline_fraction


def test_analyze_counts_sums_ranks_and_prices_each_dtype():
    rates = h100_rates()
    a = WorkCounts(flops=3e12, flops_by_dtype={"float32": 1e12,
                                               "bfloat16": 2e12},
                   hbm_bytes=4e9, collective_bytes=8e6,
                   collective_by_kind={"all_gather": 8e6},
                   collective_counts={"all_gather": 1},
                   launches={"sketch_fwd": 2})
    b = WorkCounts(flops=1e12, flops_by_dtype={"float32": 1e12},
                   hbm_bytes=2e9, launches={"sketch_fwd": 1, "gemm": 1})
    t = analyze_counts("two", [a, b], 2, model_flops=2e12)
    assert t.hlo_flops == 4e12 and t.hlo_bytes == 6e9
    assert t.collective_bytes == 8e6 and t.collective_counts == {
        "all_gather": 1}                                # a device's calls
    assert t.t_compute == (2e12 / (2 * rates.peak("float32"))
                           + 2e12 / (2 * rates.peak("bfloat16")))
    assert t.t_memory == 6e9 / (2 * rates.hbm_bw)
    assert t.t_collective == 8e6 / (2 * rates.link_bw)
    assert t.bottleneck == "compute" and t.useful_ratio == 0.5
    assert t.peak_flops == rates.peak("float32")       # 2e12 f32 vs 2e12 bf16
    one = analyze_counts("one", a, 2)
    assert one.hlo_flops == 6e12 and one.collective_bytes == 1.6e7
    with pytest.raises(ValueError, match="3 ranks' counts for 2 chips"):
        analyze_counts("bad", [a, b, a], 2)
    empty = analyze_counts("empty", WorkCounts(), 1, model_flops=1.0)
    assert empty.peak_flops == rates.peak("float32")
    assert empty.roofline_fraction == 0.0 and empty.useful_ratio is None


# -- (2) the kernels' FLOPs against the reference's HLO walk -------------------

def _hlo_flops(f, *args):
    return hlo_cost.analyze(jax.jit(f).lower(*args).compile().as_text()).flops


# (m, K, n, acc): unsplit without acc, split over K (sketch_fwd_splits /
# sketch_t_splits) with acc
FWD_CASES = [(64, 128, 16, False), (40, 1024, 32, True)]
T_CASES = [(16, 128, 64, False), (24, 2048, 5, True)]


@pytest.mark.parametrize("m,K,n,use_acc", FWD_CASES)
def test_sketch_block_flops_equal_hlo_cost(m, K, n, use_acc):
    A = _rand(m, K)
    acc = _rand(m, n, seed=1) if use_acc else None
    with counting() as c:
        local.sketch_block(A, 7, n, acc=None if acc is None else acc.clone())
    if use_acc:
        ref = _hlo_flops(lambda a, y: jlocal.sketch_block(
            a, 7, n, acc=y, backend="jnp"), A.numpy(), acc.numpy())
    else:
        ref = _hlo_flops(lambda a: jlocal.sketch_block(a, 7, n,
                                                       backend="jnp"),
                         A.numpy())
    assert c.flops == ref == 2 * m * K * n
    assert c.flops_by_dtype == {"float32": ref}
    assert c.launches == {"sketch_fwd": 1}


@pytest.mark.parametrize("m,K,n,use_acc", T_CASES)
def test_sketch_t_block_flops_equal_hlo_cost(m, K, n, use_acc):
    B = _rand(K, n)
    acc = _rand(m, n, seed=1) if use_acc else None
    with counting() as c:
        local.sketch_t_block(B, 7, m,
                             acc=None if acc is None else acc.clone())
    if use_acc:
        ref = _hlo_flops(lambda b, y: jlocal.sketch_t_block(
            b, 7, m, acc=y, backend="jnp"), B.numpy(), acc.numpy())
    else:
        ref = _hlo_flops(lambda b: jlocal.sketch_t_block(b, 7, m,
                                                         backend="jnp"),
                         B.numpy())
    assert c.flops == ref == 2 * m * K * n
    assert c.launches == {"sketch_t": 1}


@pytest.mark.parametrize("M,N,K,use_acc", [(64, 48, 128, False),
                                           (8, 40, 1024, True),
                                           (96, 72, 8, True)])
def test_gemm_block_flops_equal_hlo_cost(M, N, K, use_acc):
    A, B = _rand(M, K), _rand(K, N, seed=1)
    acc = _rand(M, N, seed=2) if use_acc else None
    with counting() as c:
        local.gemm_block(A, B, alpha=-1.0,
                         acc=None if acc is None else acc.clone())
    if use_acc:
        ref = _hlo_flops(lambda a, b, y: jlocal.gemm_block(
            a, b, alpha=-1.0, acc=y, backend="jnp"), A.numpy(), B.numpy(),
            acc.numpy())
    else:
        ref = _hlo_flops(lambda a, b: jlocal.gemm_block(
            a, b, alpha=-1.0, backend="jnp"), A.numpy(), B.numpy())
    assert c.flops == ref == 2 * M * N * K
    assert c.launches == {"gemm": 1}


# -- (3) the kernels' bytes against plan.model ---------------------------------

SHAPES = [(64, 128, 16), (40, 1024, 32), (8, 2048, 8), (4096, 32768, 512),
          (128, 8192, 128), (256000, 2304, 8), (17, 33, 5)]


@pytest.mark.parametrize("m,K,n", SHAPES)
def test_kernel_bytes_are_the_cost_models(m, K, n):
    for acc in (False, True):
        w = C.sketch_fwd_work(m, K, n, F32, F32, acc)
        assert w.nbytes == 4 * tmodel.hbm_roofline_words(m, K, n, acc)
        assert w == C.sketch_fwd_work(m, K, n, F32, F32, acc)
    # the one-card Nystrom pair: sketch_fwd, then sketch_t of B (m x n)
    # into C (n x n)
    if m == K:
        pair = (C.sketch_fwd_work(m, m, n, F32, F32, False).nbytes
                + C.sketch_t_work(n, m, n, F32, F32, False).nbytes)
        assert pair == 4 * tmodel.nystrom_local_cost(m, n).hbm_words
    # a sharded / ragged slab of k = m rows: sketch_fwd into dY, the fold
    # of its k live rows, sketch_t of the slab into W (l x n2) in place
    l = 2 * n + 1
    slab = (C.sketch_fwd_work(m, K, n, F32, F32, False).nbytes
            + C.fold_rows_work(3 * m, m, n, F32, F32, [2 * m],
                               [m]).nbytes
            + C.sketch_t_work(l, m, K, F32, F32, True).nbytes)
    assert slab == 4 * tmodel.stream_update_cost(m, K, n, l).hbm_words
    # the gradient exchange of an (m, K) leaf at rank n: K5's three calls
    r = min(n, m, K)
    calls = (C.gemm_work(r, K, m, F32, F32, F32, False).nbytes
             + C.gemm_work(m, K, r, F32, F32, BF16, False).nbytes
             + C.gemm_work(m, K, r, F32, F32, F32, True).nbytes)
    rest = 2.5 * m * K + tmodel.hbm_roofline_words(m, K, r) + 2.0 * m * r
    assert calls == 4 * (tmodel.grad_compress_cost(m, K, r, 8).hbm_words
                         - rest)
    # gen_omega: the Omega that local_torch_cost writes
    assert (C.gen_omega_work(K, n, F32).nbytes
            == 4 * (tmodel.local_torch_cost(m, K, n).hbm_words - m * K
                    - K * n - m * n))


def test_fold_and_sparse_fold_bytes_and_launches():
    # masked: only live rows (a lane of 3 rows at the top, one starting
    # past the end, one that changes nothing)
    w = C.fold_rows_work(10, 4, 8, F32, BF16, [10, 13, 10], [3, 4, 0])
    assert w == C.Work(1, 0.0, 3 * 8 * (2 * 4 + 2) + 1 * 8 * (2 * 4 + 2))
    # unmasked: every y row rewritten, the d rows the window meets read
    w = C.fold_rows_work(10, 4, 8, F32, F32, [12], None)
    assert w == C.Work(1, 0.0, 2 * 10 * 32 + 2 * 32)
    # one launch a FOLD_LANE_CAPACITY lanes that change a row
    w = C.fold_rows_work(4, 2, 4, F32, F32, [4] * 500,
                         [0] * 240 + [1] * 260)
    assert w.launches == 2 and w.nbytes == 260 * 4 * 12
    assert C.fold_rows_work(4, 2, 4, F32, F32, [4], [0]).launches == 0
    # S1: ptr, entries, the table, acc read and written
    w = C.sparse_fold_work(5, 16, 100, F32, 64, True)
    assert w == C.Work(1, 0.0, 4 * 6 + 100 * 8 + 64 * 16 * 4 + 2 * 80 * 4)
    w = C.sparse_fold_work(16, 5, 100, BF16, None, False)
    assert w == C.Work(1, 0.0, 4 * 17 + 100 * 8 + 2 * 80 * 2)
    assert C.sparse_fold_work(16, 5, 0, F32, None, False) == C.Work(0, 0, 0)
    assert C.sparse_fold_work(16, 5, 0, F32, None, True).launches == 1


# -- (4) the dispatch mode -----------------------------------------------------

def test_dispatch_mode_counts_gemms_and_bytes_not_views():
    a, b = _rand(6, 5), _rand(5, 7, seed=1)
    x = _rand(2, 3, 4, seed=2)
    with counting() as c:
        y = a @ b                                 # mm
        torch.addmm(y, a, b)                      # addmm
        torch.einsum("bij,bjk->bik", x, x.transpose(1, 2))   # bmm
        torch.matmul(a[0], b)                     # mv of a row (view)
    assert c.flops == 2 * (6 * 5 * 7) * 2 + 2 * 2 * 3 * 4 * 3 + 2 * 5 * 7
    assert c.flops_by_dtype == {"float32": c.flops}
    with counting() as v:
        a.T, a.view(30), a[1:], a.narrow(0, 1, 2), x.permute(2, 0, 1)
        torch.empty(1000), torch.empty_like(a), a.detach()
        a.as_strided((2, 2), (1, 1))
    assert (v.flops, v.hbm_bytes, v.launches) == (0, 0, {})
    z = torch.zeros(6, 5)
    with counting() as w:
        z.add_(a)                 # read z and a, write z
        z.copy_(a)                # read a, write z
        z.zero_()                 # write z
        torch.mul(a, 2.0, out=z)  # read a, write z
    assert w.hbm_bytes == 120 * (3 + 2 + 1 + 2) and w.flops == 0
    row = _rand(1, 5, seed=3)
    with counting() as b:          # a broadcast operand is read once
        a + row.expand(6, 5)
    assert b.hbm_bytes == 4 * (30 + 5 + 30)
    h = torch.ones(2, 4, dtype=BF16)
    with counting() as g:
        h @ h.T.contiguous()
    assert g.flops_by_dtype == {"bfloat16": 2 * 2 * 4 * 2}


def test_no_double_count_inside_a_kernels_plain_path():
    """The plain sketch runs the Philox and a matmul on the CPU: only the
    kernel's own count is kept; blocks nest."""
    A = _rand(32, 64)
    with counting() as outer:
        with counting() as inner:
            local.sketch_block(A, 7, 8)
        ops.gen_omega(seed=7, n2=64, r=8, device="cpu")
    want = C.sketch_fwd_work(32, 64, 8, F32, F32, False)
    assert (inner.flops, inner.hbm_bytes) == (want.flops, want.nbytes)
    assert inner.launches == {"sketch_fwd": 1}
    assert outer.flops == want.flops
    assert outer.hbm_bytes == want.nbytes + 4 * 64 * 8
    assert outer.launches == {"sketch_fwd": 1, "gen_omega": 1}
    # nothing is counted outside a block, and a sparse kind's tile is
    # torch ops (no kernel draws it)
    local.sketch_block(A, 7, 8)
    with counting() as s:
        ops.gen_omega(seed=7, n2=64, r=8, kind="countsketch", device="cpu")
    assert s.launches == {} and s.hbm_bytes > 0


def test_counts_the_sparse_fold_and_the_fold_once():
    from repro_torch.stream.state import SparseRows
    cfg = StreamConfig(64, 128, r=8, seed=3)
    st = StreamingSketch(cfg, device="cpu")
    rng = np.random.default_rng(0)
    idx = rng.choice(16 * 128, size=100, replace=False)
    sp = SparseRows((idx // 128).astype(np.int32),
                    (idx % 128).astype(np.int32),
                    rng.standard_normal(100).astype(np.float32), (16, 128))
    with counting() as c:
        st.update_rows_sparse(16, sp)
    assert c.launches == {"gen_omega": 2, "sparse_fold": 2}
    assert c.flops == 0
    y = [torch.zeros(8, 4) for _ in range(3)]
    with counting() as f:
        local.fold_rows_block(y, _rand(3, 2, 4), [8, 7, 20], [2, 1, 2])
    assert f.launches == {"fold_rows": 1} and f.hbm_bytes == 3 * 4 * 12


# -- (5) measured counts against the analytic roofline -------------------------

def _same_terms(got, want, bytes_diff=0.0):
    assert got.hlo_flops == want.hlo_flops
    assert got.hlo_bytes - want.hlo_bytes == bytes_diff
    assert got.collective_bytes == want.collective_bytes == 0
    assert got.t_compute == want.t_compute


@pytest.mark.parametrize("n,r", [(256, 16), (200, 7), (512, 64)])
def test_analyze_call_equals_analyze_cost_one_card(n, r):
    A = _rand(n, n)
    A = A + A.T
    cases = [
        (lambda: ops.sketch_matmul(A, seed=7, r=r),
         tmodel.local_cost(n, n, r), 2.0 * n * n * r),
        (lambda: sketch_reference(A, 7, r),
         tmodel.local_torch_cost(n, n, r), 2.0 * n * n * r),
        (lambda: ops.nystrom_fused(A, seed=7, r=r),
         tmodel.nystrom_local_cost(n, r), 2.0 * n * n * r + 2.0 * n * r * r),
        (lambda: nystrom_reference(A, 7, r),
         tmodel.nystrom_local_torch_cost(n, r),
         2.0 * n * n * r + 2.0 * n * r * r)]
    for fn, cost, mf in cases:
        got = analyze_call("call", fn, model_flops=mf, device="cpu")
        want = analyze_cost("cost", cost, model_flops=mf)
        _same_terms(got, want)
        assert got.useful_ratio == 1.0
        assert got.roofline_fraction == want.roofline_fraction
    # a stream slab: the solo update accumulates Y's k rows in place (read
    # and written, 2·k·r words) where the model prices the sharded and
    # ragged paths' dY written, read and folded (4·k·r): the one named
    # difference, 2·k·r words
    k = n // 4
    cfg = StreamConfig(n, n, r=r, seed=7)
    st = StreamingSketch(cfg, device="cpu")
    got = analyze_call("slab", lambda: st.update_rows(k, A[k:2 * k]),
                       device="cpu")
    want = analyze_cost("slab", tmodel.stream_update_cost(k, n, r,
                                                          cfg.sketch_l))
    _same_terms(got, want, bytes_diff=-2.0 * k * r * 4)


# -- (6) four gloo ranks -------------------------------------------------------

N1, N2, R4 = 64, 96, 16
GRIDS = [(2, 2, 1), (1, 2, 2)]


def test_alg1_fleet_collective_bytes_on_four_ranks():
    A = np.random.default_rng(5).standard_normal((N1, N2)).astype(np.float32)
    res = tdh.run_workers(tdh.roofline_worker, 4, A, 7, R4, GRIDS)
    for grid in GRIDS:
        terms = [r[grid][0] for r in res]
        comm = [r[grid][1] for r in res]
        t = terms[0]
        assert all(x == t for x in terms)          # every rank: the fleet
        fleet = sum(sum(c.values()) for c in comm) * 4
        per_rank = tmodel.alg1_cost(N1, N2, R4, grid).words
        assert per_rank == alg1_bandwidth_words(N1, N2, R4, *grid) > 0
        assert t["collective_bytes"] == fleet == 4 * 4 * per_rank
        assert t["collective_by_kind"] == {
            k: sum(c[k] for c in comm) * 4.0 for k in ("all_gather",
                                                       "reduce_scatter")
            if any(c[k] for c in comm)}
        assert t["collective_counts"] == {
            k: 1 for k in t["collective_by_kind"]}     # a device's calls
        assert t["hlo_flops"] == 2.0 * N1 * N2 * R4
        assert t["useful_ratio"] == 1.0 and t["chips"] == 4
        assert t["bottleneck"] == "collective"


# -- (7) the train step's useful FLOPs -----------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_model_flops_and_parameter_counts_equal_the_reference(reduced):
    jcfg = jax_config("gemma2-2b")
    cfg = get_config("gemma2-2b")
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    shapes = jax.eval_shape(lambda: japi.get_api(jcfg).init(
        jax.random.key(0), jcfg))
    total, expert = count_params_split(cfg)
    assert (total, expert) == japi.count_params_split(jcfg, shapes)
    if not reduced:
        assert total == 2_614_341_888
    assert count_active_params(cfg) == japi.count_active_params(jcfg, shapes)
    for shape in (ShapeConfig("t", 1024, 4, "train"),
                  ShapeConfig("p", 512, 2, "prefill"),
                  ShapeConfig("d", 512, 8, "decode")):
        assert model_flops(cfg, shape, total) == japi.model_flops(
            jcfg, shape, total) > 0
        assert model_flops(cfg, shape, total, 5) == japi.model_flops(
            jcfg, shape, total, 5)
    assert model_flops(cfg, ShapeConfig("t", 1024, 4, "train"),
                       total) == 6.0 * total * 4096


def test_expert_parameters_count_at_top_k_over_experts():
    jcfg = dataclasses.replace(jax_config("gemma2-2b").reduced(),
                               n_experts=4, top_k=2)
    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                              n_experts=4, top_k=2)
    dims = {"embed": (256, 64), "moe": {"w_gate": (4, 64, 32),
                                        "w_up": (4, 64, 32),
                                        "w_down": (4, 32, 64),
                                        "router": (64, 4)}}

    def tree(d, leaf):
        return {k: tree(v, leaf) if isinstance(v, dict) else leaf(v)
                for k, v in d.items()}
    mine = tree(dims, lambda s: torch.empty(s, device="meta"))
    ref = tree(dims, lambda s: jax.ShapeDtypeStruct(s, np.float32))
    assert count_params_split(cfg, mine) == japi.count_params_split(
        jcfg, ref) == (256 * 64 + 3 * 8192 + 256, 3 * 8192)
    assert count_active_params(cfg, mine) == japi.count_active_params(
        jcfg, ref) == 256 * 64 + 256 + 3 * 4096


# -- (8) the device ------------------------------------------------------------

def test_analyze_call_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match='device="cpu"'):
        analyze_call("x", lambda: calls.append(1))
    assert calls == []
    t = analyze_call("x", lambda: calls.append(1), device="cpu")
    assert calls == [1, 1] and t.hlo_flops == 0 and t.chips == 1
    with pytest.raises(ValueError, match="process group of 4 ranks"):
        analyze_call("x", lambda: None, chips=4, device="cpu")
