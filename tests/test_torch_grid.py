"""The port's communication bounds, grids and Alg. 1 costs against the
reference's (``repro.core.lower_bounds``, ``repro.core.grid``,
``repro.plan``).

The port keeps its own copies (pure ``math``), so every value must be
EQUAL, not close: the same arithmetic in the same order.  The sweeps are
deterministic (no Hypothesis): the shapes of ``tests/test_lower_bounds.py``
and ``tests/test_grid.py`` and the paper's scales, every regime, the case
boundaries, and P from 1 to 4096 (30000 for Theorem 3) in steps.
"""
import dataclasses
import math
import re

import pytest

from repro.core import grid as jgrid
from repro.core import lower_bounds as jlb
from repro.plan import model as jmodel
from repro.plan import planner as jplanner
from repro_torch.core import grid as tgrid
from repro_torch.core import lower_bounds as tlb
from repro_torch.plan import model as tmodel
from repro_torch.plan import planner as tplanner

# (n1, n2, r) of the reference's tests, the paper's scales, the chip's
# main path and the distributed tests' shape, and a few odd ones
MATMUL_SHAPES = [
    (100, 200, 10), (64, 256, 16), (16, 1024, 8), (8, 64, 16),
    (32, 512, 8), (4, 64, 16), (16, 48, 8), (50000, 50000, 500),
    (50000, 50000, 5000), (10 ** 6, 10 ** 6, 1000), (4096, 4096, 256),
    (32768, 32768, 512), (2000, 1999, 7), (3, 2000, 1500), (1, 8, 4),
    (2, 48, 8), (17, 33, 5),
]
P_SWEEP = sorted({1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16, 24, 31, 32, 33, 48,
                  63, 64, 65, 96, 100, 127, 128, 129, 255, 256, 257, 500,
                  511, 512, 513, 1000, 1023, 1024, 1025, 2047, 2048, 2049,
                  3000, 4000, 4095, 4096})
NYSTROM_SHAPES = [(300, 20), (4096, 256), (4096, 64), (8192, 128),
                  (50000, 5000), (64, 16), (128, 32), (3000, 2700),
                  (32768, 512), (5, 4)]
NYSTROM_P = sorted(set(P_SWEEP) | {5000, 10000, 19999, 20000, 30000})


def _boundaries(n1, n2, r):
    """P at and next to Theorem 2's case boundaries (P = n1, n1·n2/r)."""
    b = int(n1 * n2 / r)
    return sorted({p for p in (n1 - 1, n1, n1 + 1, b - 1, b, b + 1)
                   if p >= 1})


def _both(fn_t, fn_j, *args, **kw):
    """The two functions' results, or the two exceptions' types and
    messages."""
    out = []
    for fn in (fn_t, fn_j):
        try:
            out.append(("ok", fn(*args, **kw)))
        except Exception as e:  # noqa: BLE001 — compared, not swallowed
            out.append((type(e).__name__, str(e)))
    return out


def _fields(x):
    return dataclasses.astuple(x) if dataclasses.is_dataclass(x) else x


def _assert_same(fn_name, *args, **kw):
    t, j = _both(getattr(_port_of(fn_name), fn_name),
                 getattr(_ref_of(fn_name), fn_name), *args, **kw)
    assert t[0] == j[0], (fn_name, args, t, j)
    if t[0] == "ok":
        assert _fields(t[1]) == _fields(j[1]), (fn_name, args, t, j)
    else:
        assert t[1] == j[1], (fn_name, args, t, j)


def _port_of(name):
    return tlb if hasattr(tlb, name) and hasattr(jlb, name) else tgrid


def _ref_of(name):
    return jlb if hasattr(tlb, name) and hasattr(jlb, name) else jgrid


@pytest.mark.parametrize("shape", MATMUL_SHAPES, ids=str)
def test_matmul_bounds_equal_reference(shape):
    n1, n2, r = shape
    for P in sorted(set(P_SWEEP) | set(_boundaries(*shape))):
        for fn in ("matmul_regime", "matmul_access_lower_bound",
                   "matmul_lower_bound", "report_matmul"):
            _assert_same(fn, n1, n2, r, P)
        _assert_same("gemm_lower_bound", n1, n2, r, P)


@pytest.mark.parametrize("shape", MATMUL_SHAPES, ids=str)
def test_matmul_regimes_cover_all_three(shape):
    """The sweep reaches every regime the shape has, in order, on both."""
    n1, n2, r = shape
    Ps = sorted(set(P_SWEEP) | set(_boundaries(*shape)))
    got = [tlb.matmul_regime(n1, n2, r, P) for P in Ps]
    assert got == [jlb.matmul_regime(n1, n2, r, P) for P in Ps]
    assert got == sorted(got)


@pytest.mark.parametrize("shape", NYSTROM_SHAPES, ids=str)
def test_nystrom_bounds_equal_reference(shape):
    n, r = shape
    for P in sorted(set(NYSTROM_P) | {r, r + 1, n, n + 1,
                                      int(n * (n + r) / r),
                                      int(n * (n + r) / r) + 1}):
        for fn in ("nystrom_regime", "nystrom_access_lower_bound",
                   "nystrom_lower_bound", "report_nystrom"):
            _assert_same(fn, n, r, P)


# the numeric optimizers sweep 4096 points each: a subset of (shape, P),
# one in every regime
MINIMIZE_MATMUL = [(s, P) for s in [(100, 200, 10), (16, 1024, 8),
                                    (8, 64, 16), (2000, 1999, 7)]
                   for P in (1, 7, 64, 500, 4096)]
MINIMIZE_NYSTROM = [(s, P) for s in [(300, 20), (64, 16), (3000, 2700)]
                    for P in (1, 10, 200, 5000, 30000)]


@pytest.mark.parametrize("case", MINIMIZE_MATMUL, ids=str)
def test_minimize_access_matmul_equals_reference(case):
    (n1, n2, r), P = case
    _assert_same("minimize_access_matmul", n1, n2, r, P)


@pytest.mark.parametrize("case", MINIMIZE_NYSTROM, ids=str)
def test_minimize_access_nystrom_equals_reference(case):
    (n, r), P = case
    _assert_same("minimize_access_nystrom", n, r, P)


@pytest.mark.parametrize("P", P_SWEEP)
def test_factorizations_equal_reference(P):
    assert (list(tgrid.factorizations_3d(P))
            == list(jgrid.factorizations_3d(P)))


@pytest.mark.parametrize("shape", MATMUL_SHAPES, ids=str)
def test_alg1_words_and_hops_equal_reference(shape):
    n1, n2, r = shape
    for P in (1, 2, 4, 6, 8, 12, 16, 64, 256, 4096):
        for p in tgrid.factorizations_3d(P):
            assert (tgrid.alg1_bandwidth_words(n1, n2, r, *p)
                    == jgrid.alg1_bandwidth_words(n1, n2, r, *p)), p
            assert (tgrid.alg1_latency_hops(p[1], p[2])
                    == jgrid.alg1_latency_hops(p[1], p[2])), p


@pytest.mark.parametrize("shape", MATMUL_SHAPES, ids=str)
def test_select_matmul_grid_equals_reference(shape):
    n1, n2, r = shape
    for P in sorted(set(P_SWEEP) | set(_boundaries(*shape))):
        _assert_same("select_matmul_grid", n1, n2, r, P)
        _assert_same("select_matmul_grid", n1, n2, r, P,
                     exhaustive_fallback=False)


@pytest.mark.parametrize("variant", ["auto", "redist", "no_redist",
                                     "bound_driven", "bogus"])
@pytest.mark.parametrize("shape", NYSTROM_SHAPES, ids=str)
def test_select_nystrom_grids_equal_reference(shape, variant):
    n, r = shape
    for P in P_SWEEP:
        _assert_same("select_nystrom_grids", n, r, P, variant=variant)


@pytest.mark.parametrize("P", [1, 2, 4, 6, 8, 12, 16])
def test_alg2_words_and_executability_equal_reference(P):
    facs = list(tgrid.factorizations_3d(P))
    for n, r in [(64, 16), (4096, 256), (48, 12), (30, 6)]:
        for p in facs:
            for q in facs:
                assert (tgrid.alg2_bandwidth_words(n, r, p, q)
                        == jgrid.alg2_bandwidth_words(n, r, p, q))
                assert (tgrid.alg2_two_grid_executable(n, r, p, q)
                        == jgrid.alg2_two_grid_executable(n, r, p, q))


@pytest.mark.parametrize("P", [1, 2, 4, 6, 8, 12, 16, 64])
@pytest.mark.parametrize("shape", [(64, 16), (4096, 256), (48, 12),
                                   (30, 6), (7, 3)], ids=str)
def test_select_two_grid_executable_equals_reference(shape, P):
    n, r = shape
    _assert_same("select_two_grid_executable", n, r, P)
    for p in tgrid.factorizations_3d(P):
        _assert_same("select_two_grid_executable", n, r, P, p=p)


@pytest.mark.parametrize("P", [1, 2, 4, 6, 8, 12, 16, 30])
def test_two_grid_axis_split_equals_reference(P):
    facs = list(tgrid.factorizations_3d(P))
    for p in facs:
        for q in facs:
            _assert_same("two_grid_axis_split", p, q)
    _assert_same("two_grid_axis_split", (P, 1, 1), (P + 1, 1, 1))


def test_two_grid_shared_mesh_is_not_ported():
    """Ported: None where no row-major rank order serves both grids (the
    reference's None cases), the reference's ValueError where P exceeds
    the ranks there are, and the axis groups of both grids otherwise."""
    assert tgrid.two_grid_shared_mesh((2, 3, 1), (3, 2, 1), world=6) is None
    assert tgrid.two_grid_shared_mesh((2, 3, 1), (3, 2, 1), world=1) is None
    assert jgrid.two_grid_shared_mesh((2, 3, 1), (3, 2, 1)) is None
    with pytest.raises(ValueError,
                       match=re.escape("grids (4, 1, 1)/(1, 2, 2) need 4 "
                                       "devices, have 2")):
        tgrid.two_grid_shared_mesh((4, 1, 1), (1, 2, 2), world=2)
    with pytest.raises(ValueError,
                       match=re.escape("grids (2, 1, 1)/(1, 1, 2) need 2 "
                                       "devices, have 1")):
        jgrid.two_grid_shared_mesh((2, 1, 1), (1, 1, 2))
    shared = tgrid.two_grid_shared_mesh((4, 1, 1), (1, 2, 2), world=4)
    assert shared == tgrid.TwoGridSharedMesh(
        sizes=(2, 2), p=(4, 1, 1), q=(1, 2, 2),
        p_axes=(("g0", "g1"), (), ()), q_axes=((), ("g0",), ("g1",)))


def _names(idxs):
    return tuple(tuple(f"g{i}" for i in grp) for grp in idxs)


@pytest.mark.parametrize("P", list(range(1, 13)) + [16, 64])
def test_two_grid_shared_mesh_follows_the_reference_split(P):
    """For every pair of factorizations of P: None exactly where the
    reference's ``two_grid_axis_split`` is None (where its
    ``two_grid_shared_mesh`` is None), else the split's axis sizes and
    its p / q groups under the reference's axis names; at P = 1 the whole
    reference object's groups, on its one device."""
    facs = list(tgrid.factorizations_3d(P))
    for p in facs:
        for q in facs:
            split = jgrid.two_grid_axis_split(p, q)
            got = tgrid.two_grid_shared_mesh(p, q, world=P)
            if split is None:
                assert got is None, (p, q)
                continue
            sizes, pg, qg = split
            assert (got.sizes, got.p, got.q) == (sizes, p, q), (p, q)
            assert (got.p_axes, got.q_axes) == (_names(pg), _names(qg))
            for dims, axes in ((p, got.p_axes), (q, got.q_axes)):
                assert tuple(math.prod(sizes[int(a[1:])] for a in grp)
                             for grp in axes) == dims
    if P == 1:
        ref = jgrid.two_grid_shared_mesh((1, 1, 1), (1, 1, 1))
        got = tgrid.two_grid_shared_mesh((1, 1, 1), (1, 1, 1), world=1)
        assert (got.p_axes, got.q_axes) == (ref.p_axes, ref.q_axes)
        assert got.sizes == tuple(ref.mesh.shape.values())


ALG2_COST_SHAPES = [(64, 16), (64, 2), (4096, 256), (48, 12), (32768, 512),
                    (32768, 2)]


@pytest.mark.parametrize("P", list(range(1, 13)) + [16, 64])
def test_alg2_costs_price_the_reference_words(P):
    """``redistribute_words``, ``fused_redistribute_words`` and the words,
    hops and FLOPs of ``alg2_cost`` / ``alg2_fused_cost`` equal the
    reference's on every pair of factorizations of P."""
    facs = list(tgrid.factorizations_3d(P))
    for n, r in ALG2_COST_SHAPES:
        for p in facs:
            for q in facs:
                for fn in ("redistribute_words", "fused_redistribute_words"):
                    assert (getattr(tmodel, fn)(n, r, p, q)
                            == getattr(jmodel, fn)(n, r, p, q)), (fn, p, q)
                for fn in ("alg2_cost", "alg2_fused_cost"):
                    t = getattr(tmodel, fn)(n, r, p, q)
                    j = getattr(jmodel, fn)(n, r, p, q)
                    assert (t.words, t.messages, t.flops) == (
                        j.words, j.messages, j.flops), (fn, p, q)


def test_alg2_cost_prices_the_port_scratches():
    """Device-memory words: stage 1 as ``alg1_cost`` (the ``sketch_fwd``
    Omega scratch), then stage 2's gathered B block read, its (n/q1) x
    ceil4(r/q2) Omega scratch written and read, its split-K work buffer
    (``sketch_t_plan``: splits x r/q2 x r/q3) written and read, its C
    partial written — not the reference's zero-Omega Pallas pricing."""
    n, r, p, q = 32768, 512, (4, 1, 1), (1, 2, 2)
    c = tmodel.alg2_cost(n, r, p, q)
    # 64 splits of the (256, 256) output: a 4,194,304-word work buffer
    stage2 = n * r / 2 + 2 * n * 256 + 2 * 64 * 256 * 256 + 256 * 256
    assert c.hbm_words == tmodel.alg1_cost(n, n, r, p).hbm_words + stage2
    assert tmodel.alg2_fused_cost(n, r, p, q).hbm_words == c.hbm_words
    # r = 2: the scratch pads r/q2 = 2 columns to 4; 32 splits of (2, 1)
    c2 = tmodel.alg2_cost(n, 2, (4, 1, 1), (2, 1, 2))
    assert c2.hbm_words == (tmodel.alg1_cost(n, n, 2, (4, 1, 1)).hbm_words
                            + n * 2 / 4 + 2 * (n // 2) * 4 + 2 * 32 * 2 * 1
                            + 2 * 2 / 2)
    assert c.hbm_words != jmodel.alg2_cost(n, r, p, q).hbm_words


@pytest.mark.parametrize("shape", MATMUL_SHAPES, ids=str)
def test_alg1_executable_snap_equals_reference(shape):
    n1, n2, r = shape
    for P in (1, 2, 3, 4, 5, 6, 8, 12, 16, 64, 256, 1024, 4096):
        for p in tgrid.factorizations_3d(P):
            assert (tplanner._alg1_executable(n1, n2, r, p)
                    == jplanner._alg1_executable(n1, n2, r, p)), p
        assert (tplanner._best_executable_alg1_grid(n1, n2, r, P)
                == jplanner._best_executable_alg1_grid(n1, n2, r, P)), P


@pytest.mark.parametrize("shape", MATMUL_SHAPES, ids=str)
def test_alg1_cost_prices_the_reference_words(shape):
    """Words, hops and FLOPs are the reference's; the device-memory words
    price the port's Omega scratch, which the reference's fused body does
    not have."""
    n1, n2, r = shape
    for P in (1, 2, 4, 8, 16, 64):
        for p in tgrid.factorizations_3d(P):
            t, j = tmodel.alg1_cost(n1, n2, r, p), jmodel.alg1_cost(
                n1, n2, r, p)
            assert (t.words, t.messages, t.flops) == (j.words, j.messages,
                                                      j.flops), p
            tc = tmodel.alg1_communicating_cost(n1, n2, r, p)
            jc = jmodel.alg1_communicating_cost(n1, n2, r, p)
            assert (tc.words, tc.messages) == (jc.words, jc.messages), p


def test_alg1_cost_prices_the_omega_scratch():
    """The local body's Omega block is written to and read from device
    memory once each: K x ceil4(cols) f32 words."""
    n1, n2, r = 32768, 32768, 512
    c = tmodel.alg1_cost(n1, n2, r, (2, 2, 1))
    K, cols = n2 // 2, r
    assert c.hbm_words == n1 * n2 / 4 + 2 * K * cols + n1 * r / 2
    assert tmodel.alg1_cost(n1, n2, 510, (1, 1, 1)).hbm_words == (
        n1 * n2 + 2 * n2 * 512 + n1 * 510)


def test_cost_keeps_the_training_fields():
    """A Cost built from words and FLOPs alone keeps messages and
    device-memory words at 0; the exchange's costs carry the reference's
    hops (2·log2 P) and the port's device-memory words."""
    c0 = tmodel.Cost(words=1.0, flops=2.0)
    assert (c0.words, c0.flops, c0.messages, c0.hbm_words) == (1.0, 2.0,
                                                               0.0, 0.0)
    m, n, r = 256, 64, 8
    c = tmodel.grad_compress_cost(m, n, r, 2)
    assert c.messages == 2.0
    # M = G+E; sketch_fwd's narrow path (scratch n x ceil4(r), no split);
    # the QR; (a) skinny P̂ᵀ·M, too short to split; (b) thin, into bf16;
    # (c) thin, in place
    assert c.hbm_words == (2.5 * m * n + (m * n + 2 * n * r + m * r)
                           + 2 * m * r + (m * r + m * n + r * n)
                           + (m * r + r * n + 0.5 * m * n)
                           + (m * r + r * n + 2 * m * n))
    raw = tmodel.grad_allreduce_cost(m, n, 2)
    assert (raw.messages, raw.hbm_words) == (1.0, 2.0 * m * n)
