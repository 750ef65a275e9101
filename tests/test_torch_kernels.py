"""repro_torch's sketch GEMMs against the JAX reference, on the CPU.

On the CPU the port's wrappers run their plain torch versions (the CUDA
kernels are held to those on the card, tests/test_torch_cuda.py and
chip_smoke.py).  References: ``repro.kernels.local`` with
``backend="jnp"``, and ``repro.kernels.ops`` in Pallas interpret mode at
tiny shapes.

Tolerances: Omega draws are bitwise.  float32 GEMM results are held to
``rtol=1e-5``, ``atol=1e-5·max|ref|``: the two sides sum the contraction in
different orders.  bfloat16 outputs to one bfloat16 ulp: both round an f32
sum that may differ in its last bits, which can land on either side of a
bfloat16 rounding boundary.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import local as jlocal
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import rng, sketch
from repro_torch.kernels import local, ops, ref
from repro_torch.kernels.sketch_matmul import (
    FOLD_BLOCK_SLOTS, FOLD_LANE_CAPACITY, FOLD_VEC, GEMM_PATHS, GEMM_THIN_K,
    SKETCH_FWD_MAX_SPLITS, SKETCH_FWD_MIN_K_SPLIT, SKETCH_FWD_NARROW_N,
    SKETCH_FWD_TILE, SKETCH_T_MAX_SPLITS,
    SKETCH_T_MIN_K_SPLIT, SKETCH_T_SMS, SKETCH_T_TARGET_BLOCKS,
    SKETCH_T_TILE, _fold_call_struct, _fold_pack, fold_rows_cuda,
    fold_rows_plan, gemm_cuda, gemm_plan, sketch_fwd_cuda, sketch_fwd_narrow,
    sketch_fwd_plan, sketch_fwd_scratch_bytes, sketch_fwd_splits,
    sketch_t_cuda, sketch_t_scratch_bytes, sketch_t_splits)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WRAP = 2 ** 32 - 6
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}
# (m, k, cols, row0, col0, use_acc, scale): ragged shapes throughout
CASES = {
    "plain": (7, 33, 10, 0, 0, False, None),
    "offset_acc": (13, 40, 9, WRAP, 3, True, None),
    "scale": (5, 17, 12, 5, 0, False, 0.5),
    "all": (11, 29, 6, 2 ** 31, 7, True, -1.5),
}


def _close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30))


def _within_bf16_ulp(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp)


def _both(x: np.ndarray, dt: str):
    """The same values as a JAX array and a torch tensor of ``dt``."""
    _, jdt, tdt = DTYPES[dt]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x.copy()).to(tdt)


@pytest.mark.parametrize("fn", ["sketch_block", "sketch_t_block"])
@pytest.mark.parametrize("kind", ["normal", "uniform", "rademacher"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_block_matches_jnp_backend(fn, kind, dt, case):
    m, k, cols, row0, col0, use_acc, scale = CASES[case]
    gen = np.random.default_rng(sum(map(ord, fn + kind + dt + case)))
    x = gen.standard_normal((m, k) if fn == "sketch_block"
                            else (k, m)).astype(np.float32)
    jx, tx = _both(x, dt)
    out_shape = (m, cols) if fn == "sketch_block" else (cols, m)
    jacc = tacc = None
    if use_acc:
        jacc, tacc = _both(gen.standard_normal(out_shape).astype(
            np.float32), dt)
    kw = dict(row0=row0, col0=col0, kind=kind, salt=2, scale=scale)
    seed = 2 ** 35 + 17
    want = np.asarray(getattr(jlocal, fn)(jx, seed, cols, acc=jacc,
                                          backend="jnp", **kw), np.float32)
    got = getattr(local, fn)(tx, seed, cols, acc=tacc, **kw)
    assert got.dtype == tx.dtype and tuple(got.shape) == out_shape
    if use_acc:
        assert got is tacc                     # accumulated in place
    check = _close if dt == "f32" else _within_bf16_ulp
    check(got.float().numpy(), want)


def test_out_dtype_and_acc_contract():
    A = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (6, 20)).astype(np.float32))
    out = local.sketch_block(A.to(torch.bfloat16), 3, 5,
                             out_dtype=torch.float32)
    assert out.dtype == torch.float32
    want = jlocal.sketch_block(jnp.asarray(A.numpy()).astype(jnp.bfloat16),
                               3, 5, out_dtype=jnp.float32, backend="jnp")
    _close(out.numpy(), want)
    with pytest.raises(ValueError, match="acc must be"):
        local.sketch_block(A, 3, 5, acc=torch.zeros(6, 4))
    with pytest.raises(ValueError, match="acc must be"):
        local.sketch_block(A, 3, 5, acc=torch.zeros(5, 6).T)


def test_backend_knob():
    A = torch.ones(4, 8)
    assert local.resolve_backend("auto", "cpu") == "torch"
    assert local.resolve_backend("auto", "cuda") == "cuda"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        local.sketch_block(A, 0, 3, backend="cuda")
    with pytest.raises(ValueError, match="CPU path"):
        local.resolve_backend("torch", "cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        local.sketch_t_block(A, 0, 3, backend="pallas")


@pytest.mark.parametrize("m,n,K,want", [
    (1025, 32768, 4096, 1),       # the streaming W update: 9 x 256 tiles
    (257, 8192, 256, 1),          # a serving lane's W update (k <= 256)
    (257, 8192, 1, 1),
    (512, 512, 32768, 16),        # the Nystrom C: 16 tiles, 2048-row splits
    (512, 512, 1023, 1),          # too short to split
    (512, 512, 1024, 2),
    (100, 100, 10 ** 6, SKETCH_T_MAX_SPLITS),
])
def test_sketch_t_splits_at_the_main_path_shapes(m, n, K, want):
    assert sketch_t_splits(m, n, K) == want


def test_sketch_t_splits_policy():
    """The split depends on (m, n, K) alone: 1 where the tiles fill the
    SMs, else about two blocks an SM, never a split of under
    SKETCH_T_MIN_K_SPLIT rows and never more splits than K allows."""
    for m in (1, 45, 128, 129, 512, 1025, 2000):
        for n in (1, 70, 300, 512, 1930, 8192, 32768):
            tiles = -(-m // SKETCH_T_TILE) * -(-n // SKETCH_T_TILE)
            for K in (0, 1, 511, 512, 1023, 4099, 16384, 32768, 10 ** 7):
                s = sketch_t_splits(m, n, K)
                assert s == sketch_t_splits(m, n, K)
                assert 1 <= s <= SKETCH_T_MAX_SPLITS
                assert s <= max(1, K // SKETCH_T_MIN_K_SPLIT)
                if tiles >= SKETCH_T_SMS:
                    assert s == 1
                if s > 1:
                    assert K // s >= SKETCH_T_MIN_K_SPLIT
                    assert tiles * s <= SKETCH_T_TARGET_BLOCKS


@pytest.mark.parametrize("m,K,want", [
    (1025, 4096, 4096 * 1028 * 4),        # the W update: 16.8 MB
    (512, 32768, 64 * 2 ** 20),           # the Nystrom C: 64 MiB
    (257, 256, 256 * 260 * 4),            # a serving lane at k = 256
    (45, 133, 133 * 48 * 4),
    (4, 3, 48), (1, 0, 0), (0, 5, 0),
])
def test_sketch_t_scratch_bytes(m, K, want):
    assert sketch_t_scratch_bytes(m, K) == want


def test_sketch_t_on_the_cpu_takes_the_plain_path(monkeypatch):
    """A CPU tensor never reaches the launcher (so no scratch is sized or
    allocated), and the launcher refuses one before allocating."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the CUDA launcher")
    monkeypatch.setattr(local, "sketch_t_cuda", refuse)
    monkeypatch.setattr(sys.modules["repro_torch.kernels.sketch_matmul"],
                        "sketch_t_scratch_bytes", refuse)
    gen = np.random.default_rng(7)
    B = torch.from_numpy(gen.standard_normal((40, 9)).astype(np.float32))
    acc = torch.from_numpy(gen.standard_normal((6, 9)).astype(np.float32))
    want = local._sketch_t_block_torch(B, 3, 6, row0=WRAP, acc=acc)
    got = local.sketch_t_block(B, 3, 6, row0=WRAP, acc=acc)
    assert got is acc and torch.equal(got, want)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        sketch_t_cuda(B, 3, 0, 6)


@pytest.mark.parametrize("n,K,want,narrow", [
    (512, 32768, 1, False),       # one-shot and streaming: never split
    (512, 4096, 1, False),
    (128, 8192, 16, False),       # a serving lane: 16 splits of 512 rows
    (128, 32768, SKETCH_FWD_MAX_SPLITS, False),
    (70, 1024, 2, False),
    (17, 8192, 16, False),
    (129, 8192, 1, False),        # two column tiles: not split
    (8, 2304, 1, True),           # the exchange's embed leaf
    (8, 9216, 1, True),           # the exchange's d_ff leaves
    (16, 10 ** 6, 1, True),
    (1, 5, 1, True),
    (128, 1023, 1, False),        # too short to split
    (128, 511, 1, False),
    (300, 0, 1, False),
])
def test_sketch_fwd_splits_at_the_main_path_shapes(n, K, want, narrow):
    assert sketch_fwd_splits(n, K) == want
    assert sketch_fwd_narrow(n) is narrow


def test_sketch_fwd_policy_does_not_depend_on_m():
    """The path and the split are functions of (n, K): at every m the
    launcher takes the same ones, so a row's sum has the same order in a
    slab, a ragged lane and a one-shot sketch.  Splits stay in [1, 64],
    never under SKETCH_FWD_MIN_K_SPLIT rows, and only the work buffer
    grows with m."""
    ms = (1, 40, 96, 128, 129, 256, 4096, 32768, 256000)
    for n in (1, 4, 5, 8, 9, 16, 17, 45, 70, 128, 129, 300, 512, 2304):
        for K in (0, 1, 133, 511, 512, 1023, 2304, 4099, 8192, 9216, 32768,
                  10 ** 7):
            plans = [sketch_fwd_plan(m, n, K) for m in ms]
            for key in ("path", "splits", "scratch_bytes"):
                assert len({p[key] for p in plans}) == 1, (n, K, key)
            s = plans[0]["splits"]
            assert plans[0]["path"] == ("narrow" if n <= SKETCH_FWD_NARROW_N
                                        else "wide")
            assert 1 <= s <= SKETCH_FWD_MAX_SPLITS
            assert s <= max(1, K // SKETCH_FWD_MIN_K_SPLIT)
            if s > 1:
                assert plans[0]["path"] == "wide" and n <= SKETCH_FWD_TILE
                assert K // s >= SKETCH_FWD_MIN_K_SPLIT
            for m, p in zip(ms, plans):
                assert p["work_bytes"] == (s * m * n * 4 if s > 1 else 0)


@pytest.mark.parametrize("n,K,want", [
    (512, 32768, 64 * 2 ** 20),           # A = 32768²: 64 MiB
    (512, 4096, 8 * 2 ** 20),             # one streaming slab's Omega rows
    (128, 8192, 4 * 2 ** 20),             # a serving lane: 4 MiB
    (8, 2304, 2304 * 8 * 4),              # the embed leaf: 72 KiB
    (70, 133, 133 * 72 * 4),
    (5, 3, 3 * 8 * 4), (1, 0, 0), (0, 5, 0),
])
def test_sketch_fwd_scratch_bytes(n, K, want):
    assert sketch_fwd_scratch_bytes(n, K) == want
    assert sketch_fwd_plan(7, n, K)["scratch_bytes"] == want


def test_sketch_fwd_on_the_cpu_takes_the_plain_path(monkeypatch):
    """A CPU tensor never reaches the launcher (so no scratch or work
    buffer is sized or allocated), with acc, with out= and without either;
    the launcher refuses one before allocating."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the CUDA launcher")
    monkeypatch.setattr(local, "sketch_fwd_cuda", refuse)
    mod = sys.modules["repro_torch.kernels.sketch_matmul"]
    for name in ("sketch_fwd_plan", "sketch_fwd_scratch_bytes",
                 "sketch_fwd_splits"):
        monkeypatch.setattr(mod, name, refuse)
    gen = np.random.default_rng(8)
    A = torch.from_numpy(gen.standard_normal((9, 40)).astype(np.float32))
    acc = torch.from_numpy(gen.standard_normal((9, 6)).astype(np.float32))
    want = local._sketch_block_torch(A, 3, 6, row0=WRAP, acc=acc)
    got = local.sketch_block(A, 3, 6, row0=WRAP, acc=acc)
    assert got is acc and torch.equal(got, want)
    buf = torch.zeros(2, 12, 6)
    view = buf[1, :9]
    got = local.sketch_block(A, 3, 6, out=view, out_dtype=torch.float32)
    assert got is view and torch.equal(
        buf[1, :9], local._sketch_block_torch(A, 3, 6))
    assert not buf[0].any() and not buf[1, 9:].any()
    assert torch.equal(local.sketch_block(A, 3, 6),
                       local._sketch_block_torch(A, 3, 6))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        sketch_fwd_cuda(A, 3, 0, 6)


# (m, n) of gemma2-2b's compressed leaves and the split of the exchange's
# call (a) on each (P^T·M: M = r = 8, K = m): ceil(1056 / ceil(n / 128))
# blocks, never a split under 512 rows of K
GEMM_LEAVES = {
    "embed": ((256000, 2304), 59),
    "w_down": ((239616, 2304), 59),
    "wo": ((53248, 2304), 59),
    "wq": ((59904, 2048), 66),
    "w_gate_up": ((59904, 9216), 15),
    "wk_wv": ((59904, 1024), 117),      # 59904 // 512 binds
    "norm": ((26, 2304), 1),            # K = 26: too short to split
}


@pytest.mark.parametrize("leaf", list(GEMM_LEAVES))
@pytest.mark.parametrize("call", ["a", "b", "c"])
def test_gemm_plan_at_the_main_path_shapes(leaf, call):
    """Calls (b) and (c) (K = r = 8) of every compressed leaf take the thin
    kernel with no split and no work buffer; call (a) takes the skinny
    kernel, split over K into a splits x r x n f32 work buffer."""
    (m, n), splits_a = GEMM_LEAVES[leaf]
    r = 8
    if call == "a":
        plan = gemm_plan(r, n, m)
        want = {"path": "skinny", "splits": splits_a,
                "work_bytes": splits_a * r * n * 4 if splits_a > 1 else 0}
    else:
        plan = gemm_plan(m, n, r)
        want = {"path": "thin", "splits": 1, "work_bytes": 0}
    assert plan == want


def test_gemm_plan_thin_for_every_short_contraction():
    """K <= GEMM_THIN_K is always thin (no split, no work buffer) at any M
    and N; one more row of K goes to the skinny kernel for M <= 32 and to
    the tiled one above; every path has a code of rt_gemm."""
    assert GEMM_THIN_K == 16 and set(GEMM_PATHS) == {"thin", "skinny",
                                                     "tiled"}
    for M in (1, 5, 26, 32, 33, 1000, 4099, 256000):
        for N in (1, 77, 1024, 2304, 2305, 9216):
            for K in range(GEMM_THIN_K + 1):
                assert gemm_plan(M, N, K) == {"path": "thin", "splits": 1,
                                              "work_bytes": 0}, (M, N, K)
            over = gemm_plan(M, N, GEMM_THIN_K + 1)
            assert over["path"] == ("skinny" if M <= 32 else "tiled")
            assert over["splits"] == 1
    assert gemm_plan(33, 2304, 10 ** 6)["path"] == "tiled"
    assert gemm_plan(33, 2304, 10 ** 6)["splits"] == 1


def test_gemm_on_the_cpu_takes_the_plain_path(monkeypatch):
    """A CPU tensor never reaches gemm_cuda or gemm_plan (nothing is sized
    or allocated for the card), with acc in place, with a bf16 out= view
    and with neither; the launcher refuses one before planning."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the CUDA launcher")
    monkeypatch.setattr(local, "gemm_cuda", refuse)
    mod = sys.modules["repro_torch.kernels.sketch_matmul"]
    for name in ("gemm_plan", "gemm_splits"):
        monkeypatch.setattr(mod, name, refuse)
    gen = np.random.default_rng(9)
    P = torch.from_numpy(gen.standard_normal((40, 8)).astype(np.float32))
    Qt = torch.from_numpy(gen.standard_normal((8, 12)).astype(np.float32))
    M = torch.from_numpy(gen.standard_normal((40, 12)).astype(np.float32))
    want = local._gemm_block_torch(P, Qt, -1.0, M)
    got = local.gemm_block(P, Qt, alpha=-1.0, acc=M)
    assert got is M and torch.equal(got, want)
    buf = torch.zeros(2, 50, 12, dtype=torch.bfloat16)
    view = buf[1, :40]
    got = local.gemm_block(P, Qt, out_dtype=torch.bfloat16, out=view)
    assert got is view and torch.equal(
        buf[1, :40], local._gemm_block_torch(P, Qt,
                                             out_dtype=torch.bfloat16))
    assert not buf[0].any() and not buf[1, 40:].any()
    assert torch.equal(local.gemm_block(P.T, M),
                       local._gemm_block_torch(P.T, M))
    with pytest.raises(ValueError, match="must be a 2-D float32 CUDA"):
        gemm_cuda(P, Qt)


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("ydt,ddt", [(F32, F32), (BF16, F32), (BF16, BF16),
                                     (F32, BF16)])
@pytest.mark.parametrize("c", [128, 20, 8, 4, 4100])
def test_fold_rows_plan_vector_path_when_aligned(ydt, ddt, c):
    """Aligned lanes with c % 4 == 0 take the 4-column vector path (16
    bytes a thread in f32, 8 in bf16) for every dtype pair; a block covers
    whole rows, FOLD_BLOCK_SLOTS vector slots a pass (one row at least).
    The service's bucket (c = r = 128) takes 32 rows a block."""
    assert FOLD_VEC == 4 and FOLD_BLOCK_SLOTS == 1024
    plan = fold_rows_plan(64, 16384, 256, c, ydt, ddt, aligned=True)
    assert plan == {"vec": 4, "rows": max(1, 1024 // (c // 4)),
                    "launches": 1}
    if c == 128:
        assert plan["rows"] == 32


@pytest.mark.parametrize("ydt,ddt", [(F32, F32), (BF16, F32), (BF16, BF16)])
@pytest.mark.parametrize("c,aligned", [(45, True), (45, False), (128, False),
                                       (2, True), (1030, True)])
def test_fold_rows_plan_scalar_path(ydt, ddt, c, aligned):
    """c = 45 (or any c % 4 != 0), or a lane off a 16-byte boundary (a view
    at an odd element), takes the one-element path."""
    plan = fold_rows_plan(9, 2000, 77, c, ydt, ddt, aligned=aligned)
    assert plan == {"vec": 1, "rows": max(1, 1024 // c), "launches": 1}


@pytest.mark.parametrize("lanes,launches", [
    (1, 1), (64, 1), (FOLD_LANE_CAPACITY, 1), (FOLD_LANE_CAPACITY + 1, 2),
    (500, 3), (3 * FOLD_LANE_CAPACITY, 3), (65535, 274)])
def test_fold_rows_plan_launches(lanes, launches):
    """ceil(lanes / capacity) launches: the service's window of 64 lanes
    is one; the capacity fits the lanes (16 bytes each) in the 4 KB
    parameter block."""
    assert FOLD_LANE_CAPACITY * 16 <= 4096 - 64
    plan = fold_rows_plan(lanes, 16384, 256, 128, F32, F32, aligned=True)
    assert plan["launches"] == launches == -(-lanes // FOLD_LANE_CAPACITY)


@pytest.mark.parametrize("bad", [
    dict(y_dtype=torch.float64), dict(d_dtype=torch.float16),
    dict(lanes=65536), dict(m=2 ** 31), dict(c=2 ** 31)])
def test_fold_rows_plan_refuses(bad):
    args = dict(lanes=4, m=100, k=10, c=128, y_dtype=F32, d_dtype=F32,
                aligned=True)
    args.update(bad)
    with pytest.raises(ValueError, match="fold_rows"):
        fold_rows_plan(**args)


def test_fold_rows_pack_reads_alignment_from_the_pointers():
    """The host decides the vector path from the pointer values of this
    call: a lane that is a view at an odd element (or a d at one) puts the
    whole call on the one-element path.  A call record is rt_fold_rows's
    FoldCall header (d's address; n, m, k, c, span, masked, vec, rows,
    y_bf16, d_bf16), then n uint64 pointers, n int32 starts and n int32
    nvalids, one record per FOLD_LANE_CAPACITY lanes with d's address
    advanced by whole lanes; a launch whose lanes change no row is left
    out."""
    m, k, c = 6, 3, 8
    ys = [torch.zeros(m, c) for _ in range(3)]
    d = torch.zeros(3, k, c)
    ptrs = [y.data_ptr() for y in ys]
    plan, calls = _fold_pack(F32, d, m, k, c, ptrs, [1, 2, 3], [3, 0, 2])
    assert plan["vec"] == 4 and len(calls) == 1
    assert _fold_call_struct(3).unpack(calls[0]) == (
        d.data_ptr(), 3, m, k, c, 3, 1, 4, plan["rows"], 0, 0, *ptrs,
        1, 2, 3, 3, 0, 2)
    assert _fold_call_struct(3).size == 48 + 16 * 3
    plan, calls = _fold_pack(BF16, d.bfloat16(), m, k, c, ptrs, [1, 2, 3],
                             None)
    head = _fold_call_struct(3).unpack(calls[0])[:11]
    assert head[5:] == (m, 0, 4, plan["rows"], 1, 1)
    buf = torch.zeros(m * c + 1)
    odd = buf[1:].view(m, c)                      # 4 bytes off a boundary
    plan, _ = _fold_pack(F32, d, m, k, c, [ptrs[0], odd.data_ptr(), ptrs[2]],
                         [1, 2, 3], None)
    assert plan["vec"] == 1
    dbuf = torch.zeros(3 * k * c + 1)
    plan, _ = _fold_pack(F32, dbuf[1:].view(3, k, c), m, k, c, ptrs,
                         [1, 2, 3], None)
    assert plan["vec"] == 1
    n = FOLD_LANE_CAPACITY + 5
    big = torch.zeros(n, k, c)
    nv = [0] * FOLD_LANE_CAPACITY + [1] * 5
    plan, calls = _fold_pack(F32, big, m, k, c, [ptrs[0]] * n,
                             list(range(n)), nv)
    assert plan["launches"] == 2 and len(calls) == 1   # the first: no row
    rec = _fold_call_struct(5).unpack(calls[0])
    assert rec[:6] == (big.data_ptr() + FOLD_LANE_CAPACITY * k * c * 4, 5,
                       m, k, c, 1)
    assert rec[11 + 5:11 + 10] == tuple(range(FOLD_LANE_CAPACITY, n))
    plan, calls = _fold_pack(F32, big, m, k, c, [ptrs[0]] * n,
                             list(range(n)), None)
    heads = [_fold_call_struct(len(call) // 16 - 3).unpack(call)[:6]
             for call in calls]
    assert [h[1] for h in heads] == [FOLD_LANE_CAPACITY, 5]
    assert [h[5] for h in heads] == [m, m]


def test_fold_rows_on_the_cpu_takes_the_plain_path(monkeypatch):
    """A CPU d never reaches fold_rows_cuda or its plan; the launcher
    refuses one before reading any lane."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the CUDA launcher")
    monkeypatch.setattr(local, "fold_rows_cuda", refuse)
    mod = sys.modules["repro_torch.kernels.sketch_matmul"]
    for name in ("fold_rows_plan", "_fold_pack", "_fold_launch"):
        monkeypatch.setattr(mod, name, refuse)
    gen = np.random.default_rng(10)
    y = torch.from_numpy(gen.standard_normal((3, 9, 8)).astype(np.float32))
    d = torch.from_numpy(gen.standard_normal((3, 4, 8)).astype(np.float32))
    want = local._fold_rows_torch(y, d, [9, 7, 12], [4, 2, 3])
    ys = [y[i].clone() for i in range(3)]
    assert local.fold_rows_block(ys, d, [9, 7, 12], [4, 2, 3]) is not None
    assert torch.equal(torch.stack(ys), want)
    with pytest.raises(ValueError, match="must be a contiguous float32/"
                                         "bfloat16 CUDA tensor"):
        fold_rows_cuda(ys, d, [9, 7, 12], [4, 2, 3])
    with pytest.raises(ValueError, match=r"d must be \(lanes=2"):
        fold_rows_cuda(ys[:2], d, [9, 7], [4, 2])


@pytest.mark.parametrize("kind", ["normal", "uniform", "rademacher"])
def test_ops_match_pallas_interpret(kind):
    gen = np.random.default_rng(5)
    A = gen.standard_normal((20, 36)).astype(np.float32)
    jB = jops.sketch_matmul(jnp.asarray(A), seed=41, r=12, kind=kind,
                            interpret=True)
    tB = ops.sketch_matmul(torch.from_numpy(A), seed=41, r=12, kind=kind)
    _close(tB.numpy(), jB)
    jC = jops.sketch_t_matmul(jB, seed=41, r=12, kind=kind,
                              interpret=True)
    tC = ops.sketch_t_matmul(tB, seed=41, r=12, kind=kind)
    _close(tC.numpy(), jC)
    jB2, jC2 = jops.nystrom_fused(jnp.asarray(A[:, :20] + A[:, :20].T),
                                  seed=41, r=12, kind=kind, interpret=True)
    tB2, tC2 = ops.nystrom_fused(torch.from_numpy(A[:, :20] + A[:, :20].T),
                                 seed=41, r=12, kind=kind)
    _close(tB2.numpy(), jB2)
    _close(tC2.numpy(), jC2)


@pytest.mark.parametrize("kind", ["normal", "uniform", "rademacher"])
def test_gen_omega_bitwise_vs_interpret_and_ref(kind):
    want = np.asarray(jops.gen_omega(seed=2 ** 33 + 1, n2=37, r=13, br=16,
                                     bc=8, kind=kind, salt=1,
                                     interpret=True))
    got = ops.gen_omega(seed=2 ** 33 + 1, n2=37, r=13, kind=kind, salt=1,
                        device="cpu").numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(
        ref.omega_ref(2 ** 33 + 1, 37, 13, kind, salt=1,
                      device="cpu").numpy(),
        np.asarray(jref.omega_ref(2 ** 33 + 1, 37, 13, kind, salt=1)))


def test_ref_oracles_match():
    gen = np.random.default_rng(6)
    A = gen.standard_normal((9, 31)).astype(np.float32)
    _close(ref.sketch_matmul_ref(torch.from_numpy(A), 3, 7).numpy(),
           jref.sketch_matmul_ref(jnp.asarray(A), 3, 7))
    _close(ref.sketch_t_matmul_ref(torch.from_numpy(A.T.copy()), 3, 7,
                                   "rademacher").numpy(),
           jref.sketch_t_matmul_ref(jnp.asarray(A.T), 3, 7, "rademacher"))


@pytest.mark.parametrize("draw", [
    lambda: ref.omega_ref(1, 8, 4),
    lambda: ops.gen_omega(seed=1, n2=8, r=4),
    lambda: rng.philox_omega_full(1, 8, 4),
    lambda: sketch.omega_tile(1, 0, 0, 8, 4),
], ids=["omega_ref", "gen_omega", "philox_omega_full", "omega_tile"])
def test_draws_need_cuda_without_device(monkeypatch, draw):
    """``device=None`` means the card; without one the draw raises and
    names the CPU opt-in instead of dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        draw()


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port, and chip_smoke.py, in a fresh process."""
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(mods) >= 16
