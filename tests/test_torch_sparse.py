"""repro_torch's sparse row slabs (COO payloads of the local stream) on the
CPU, against the reference's.

The port's ``update_rows_sparse`` is held BITWISE to the reference's
(``backend="xla"``, a sequential scatter that rounds to the stream dtype at
each product and each add): every kind, float32 and bfloat16, two slabs
(the second onto a nonzero W), repeated coordinates, an unsorted entry
order, ``-0.0`` values and an empty payload.  Against the port's own dense
path (``update_rows`` of the densified slab) it is held to ``atol=1e-5``,
as the reference's ``tests/test_sparse.py`` holds its own: only the order
of summation differs.  Lanes of ``update_sparse_batch`` are bitwise the
solo updates and the reference's batch.  The CSR that the card path hands
the S1 kernel, walked as the kernel walks it, gives the bits of the plain
wave form (the kernel itself runs in ``tests/test_torch_cuda.py``).

Inputs are made by numpy from a seed and copied before each package gets
them (JAX on the CPU may alias a numpy buffer).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import stream as jstream
from repro.plan import model as jmodel
from repro.stream.state import _local_sig as j_local_sig
from repro.stream.state import local_sparse_prog
from repro_torch.core.sketch import GridGroups
from repro_torch.kernels import sparse_fold_block
from repro_torch.kernels.local import (_sparse_fold_torch, sparse_csr,
                                       sparse_fold_operands)
from repro_torch.kernels.sketch_matmul import sparse_fold_plan
from repro_torch.obs import metrics as obs_metrics
from repro_torch.plan import sparse_payload_words
from repro_torch.stream import (SketchService, SparseRows, StreamConfig,
                                StreamingSketch)

SEED = 7
KINDS = ("normal", "uniform", "rademacher", "countsketch", "rowsample")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def bits(x) -> np.ndarray:
    """The raw bits of a torch tensor or a JAX array, as unsigned ints."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.view(torch.int32).numpy().view(np.uint32)
    a = np.asarray(x)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def assert_bitwise(got, ref):
    np.testing.assert_array_equal(bits(got), bits(ref))


def configs(kind="normal", dtype="float32", n1=48, n2=64, r=8, seed=SEED):
    tdt, jdt = DTYPES[dtype]
    return (StreamConfig(n1=n1, n2=n2, r=r, seed=seed, kind=kind, dtype=tdt),
            jstream.StreamConfig(n1=n1, n2=n2, r=r, seed=seed, kind=kind,
                                 dtype=jdt))


def coo(rng, k, n2, nnz, repeats=0, neg_zeros=0):
    """(row, col, val): ``nnz`` distinct coordinates with standard-normal
    values, ``repeats`` more entries on coordinates already drawn (new
    values), the first ``neg_zeros`` values -0.0, the whole shuffled."""
    idx = rng.choice(k * n2, size=nnz, replace=False)
    val = rng.standard_normal(nnz).astype(np.float32)
    if repeats:
        idx = np.concatenate([idx, idx[rng.integers(0, nnz, repeats)]])
        val = np.concatenate([val, rng.standard_normal(repeats)
                              .astype(np.float32)])
    val[:neg_zeros] = -0.0
    order = rng.permutation(idx.size)
    idx, val = idx[order], val[order]
    return ((idx // n2).astype(np.int32), (idx % n2).astype(np.int32), val)


def pair(payload, shape):
    """The same payload as the port's and the reference's SparseRows, each
    with its own copy of the arrays."""
    row, col, val = payload
    return (SparseRows(row.copy(), col.copy(), val.copy(), shape),
            jstream.SparseRows(row.copy(), col.copy(), val.copy(), shape))


def sparse_slab(rng, k, n2, nnz):
    H = np.zeros((k, n2), np.float32)
    H.flat[rng.choice(k * n2, size=nnz, replace=False)] = (
        rng.standard_normal(nnz).astype(np.float32))
    return H


# ---------------------------------------------------------------------------
# SparseRows
# ---------------------------------------------------------------------------

def test_sparse_rows_roundtrip_matches_reference():
    H = np.zeros((6, 10), np.float32)
    H[1, 3] = 2.0
    H[5, 9] = -1.5
    H[0, 0] = 0.25
    sp = SparseRows.from_dense(H.copy())
    ref = jstream.SparseRows.from_dense(H.copy())
    assert sp.nnz == ref.nnz == 3 and sp.shape == ref.shape == (6, 10)
    for a, b in ((sp.row, ref.row), (sp.col, ref.col), (sp.val, ref.val)):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    np.testing.assert_array_equal(sp.to_dense(), H)
    for got, want in zip(sp.padded(8), ref.padded(8)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    row, col, val = sp.padded(8)
    assert (row[3:] == 6).all() and (col[3:] == 10).all()
    assert (val[3:] == 0).all()
    with pytest.raises(ValueError, match="exceeds bucket"):
        sp.padded(2)


def test_sparse_rows_to_dense_sums_repeats_and_takes_tensors():
    row = torch.tensor([0, 2, 0, 2], dtype=torch.int32)
    col = torch.tensor([1, 3, 1, 0], dtype=torch.int32)
    val = torch.tensor([1.0, 2.0, 0.5, -4.0])
    sp = SparseRows(row, col, val, (3, 4))
    assert sp.nnz == 4
    want = np.zeros((3, 4), np.float32)
    want[0, 1], want[2, 3], want[2, 0] = 1.5, 2.0, -4.0
    got = sp.to_dense()
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    sp.validate(StreamConfig(n1=8, n2=4, r=2), 5)
    back = SparseRows.from_dense(torch.from_numpy(want))
    np.testing.assert_array_equal(back.to_dense(), want)


@pytest.mark.parametrize("case", ["ragged", "row_high", "row_negative",
                                  "col_high", "block"])
def test_sparse_rows_validate_errors(case):
    cfg = StreamConfig(n1=16, n2=8, r=2)
    row = np.array([0, 1, 2], np.int32)
    col = np.array([0, 5, 7], np.int32)
    val = np.ones(3, np.float32)
    shape, row0, match = (4, 8), 0, "outside slab"
    if case == "ragged":
        val, match = np.ones(2, np.float32), "ragged COO"
    elif case == "row_high":
        row = np.array([0, 4, 2], np.int32)
    elif case == "row_negative":
        row = np.array([0, -1, 2], np.int32)
    elif case == "col_high":
        col = np.array([0, 8, 7], np.int32)
    else:
        row0, match = 13, "row block"
    for cls in (SparseRows, jstream.SparseRows):
        jcfg = jstream.StreamConfig(n1=16, n2=8, r=2)
        with pytest.raises(ValueError, match=match):
            cls(row, col, val, shape).validate(
                cfg if cls is SparseRows else jcfg, row0)


# ---------------------------------------------------------------------------
# bitwise against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_update_rows_sparse_bitwise_vs_reference(kind, dtype):
    """Two slabs (the second onto the nonzero W of the first), repeated
    coordinates, a shuffled entry order and -0.0 values."""
    tcfg, jcfg = configs(kind, dtype)
    port = StreamingSketch(tcfg, device="cpu")
    ref = jstream.StreamingSketch(jcfg, backend="xla")
    rng = np.random.default_rng(11)
    for row0, nnz, repeats in ((0, 200, 60), (32, 150, 40)):
        sp, jsp = pair(coo(rng, 16, 64, nnz, repeats, neg_zeros=5),
                       (16, 64))
        port.update_rows_sparse(row0, sp)
        ref.update_rows_sparse(row0, jsp)
        assert_bitwise(port.Y, ref.Y)
        assert_bitwise(port.W, ref.W)
    assert port.num_updates == 2
    assert torch.count_nonzero(port.W) > 0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["normal", "countsketch"])
def test_empty_payload_and_empty_rows_bitwise_vs_reference(kind, dtype):
    """nnz == 0 still adds +0.0 to every row of the slab (a resident -0.0
    becomes +0.0, as the reference's ``Yk + dY``), leaves W alone; a slab
    whose entries miss some rows and columns does the same there."""
    tcfg, jcfg = configs(kind, dtype)
    port = StreamingSketch(tcfg, device="cpu")
    ref = jstream.StreamingSketch(jcfg, backend="xla")
    port.Y.fill_(-0.0)
    port.W.fill_(-0.0)
    ref.Y = jnp.full(ref.Y.shape, -0.0, ref.Y.dtype)
    ref.W = jnp.full(ref.W.shape, -0.0, ref.W.dtype)
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32),
             np.zeros(0, np.float32))
    rng = np.random.default_rng(12)
    few = coo(rng, 16, 64, 5)
    for row0, payload in ((8, empty), (24, few)):
        sp, jsp = pair(payload, (16, 64))
        port.update_rows_sparse(row0, sp)
        ref.update_rows_sparse(row0, jsp)
        assert_bitwise(port.Y, ref.Y)
        assert_bitwise(port.W, ref.W)
    Yb = bits(port.Y)
    neg = 0x8000 if dtype == "bfloat16" else 0x80000000
    assert (Yb[8:40] != neg).all() and (Yb[:8] == neg).all()
    assert (bits(port.W) == neg).any()


@pytest.mark.parametrize("kind", ["countsketch", "normal"])
def test_reference_pad_buckets_equal_the_port(kind):
    """The reference at its own bucket (pow2(19) = 32) and at a forced
    256 both give the port's bits: pads change nothing, and the port
    needs none."""
    tcfg, jcfg = configs(kind, n1=32, n2=48)
    H = sparse_slab(np.random.default_rng(3), 8, 48, 19)
    sp = SparseRows.from_dense(H.copy())
    jsp = jstream.SparseRows.from_dense(H.copy())
    port = StreamingSketch(tcfg, device="cpu").update_rows_sparse(8, sp)
    a = jstream.StreamingSketch(jcfg, backend="xla")
    a.update_rows_sparse(8, jsp)
    row, col, val = jsp.padded(256)
    fn = local_sparse_prog(j_local_sig(jcfg), 8, 256)
    b = jstream.StreamingSketch(jcfg, backend="xla")
    Y, W = fn(b.Y, b.W, jnp.asarray(row), jnp.asarray(col),
              jnp.asarray(val, jcfg.dtype), b._keys, jnp.int32(8))
    for ref_Y, ref_W in ((a.Y, a.W), (Y, W)):
        assert_bitwise(port.Y, ref_Y)
        assert_bitwise(port.W, ref_W)


@pytest.mark.parametrize("kind", KINDS)
def test_update_rows_sparse_vs_dense_path(kind):
    """The port's COO update against its own dense row-block update of
    the densified slabs: the same numbers summed in another order."""
    tcfg, _ = configs(kind)
    rng = np.random.default_rng(2)
    H1 = sparse_slab(rng, 16, 64, 41)
    H2 = sparse_slab(rng, 16, 64, 7)
    a = StreamingSketch(tcfg, device="cpu")
    a.update_rows_sparse(0, SparseRows.from_dense(H1))
    a.update_rows_sparse(32, SparseRows.from_dense(H2))
    d = StreamingSketch(tcfg, device="cpu")
    d.update_rows(0, torch.from_numpy(H1))
    d.update_rows(32, torch.from_numpy(H2))
    np.testing.assert_allclose(a.Y.numpy(), d.Y.numpy(), atol=1e-5)
    np.testing.assert_allclose(a.W.numpy(), d.W.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# the fold: the card path's CSR, walked as the kernel walks it
# ---------------------------------------------------------------------------

def _round(x: np.ndarray, dtype) -> np.ndarray:
    t = torch.from_numpy(np.asarray(x, np.float32))
    return t.to(dtype).to(torch.float32).numpy()


def _kernel_walk(acc, ptr, val, table, src, cell, coef, axis, from_zero):
    """S1's arithmetic over the CSR operands, in numpy: one element of one
    segment at a time, entries in CSR order, each product and add rounded
    to acc's dtype, the segment untouched when it has no entries and the
    sums accumulate into acc."""
    out = acc.to(torch.float32).numpy().copy()
    view = out if axis == 0 else out.T
    f = lambda X: None if X is None else X.to(torch.float32).numpy()
    val, table, coef = f(val), f(table), f(coef)
    ptr = ptr.numpy()
    for s in range(view.shape[0]):
        lo, hi = ptr[s], ptr[s + 1]
        if lo == hi and not from_zero:
            continue
        total = (np.zeros(view.shape[1], np.float32) if from_zero
                 else view[s].copy())
        for p in range(lo, hi):
            if table is not None:
                x = table[src[p]]
            else:
                x = np.zeros(view.shape[1], np.float32)
                x[cell[p]] = coef[p]
            prod = _round(np.float32(val[p]) * x, acc.dtype)
            upd = _round(total + prod, acc.dtype)
            total = upd if table is not None else np.where(
                np.arange(view.shape[1]) == cell[p], upd, total)
        view[s] = _round(view[s] + total, acc.dtype) if from_zero else total
    return torch.from_numpy(out).to(acc.dtype)


@pytest.mark.parametrize("from_zero", [True, False])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("form", ["table", "cell"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_csr_walk_equals_the_wave_form(dtype, form, axis, from_zero):
    """The operands ``sparse_fold_block`` hands the kernel (a stable CSR),
    walked as S1 walks them, give the plain wave form's bits: repeated
    destinations in any order, empty segments, -0.0 in acc and in val."""
    tdt = DTYPES[dtype][0]
    rng = np.random.default_rng(5)
    acc = torch.from_numpy(rng.standard_normal((9, 7)).astype(np.float32))
    acc = acc.to(tdt)
    acc[0, :2] = -0.0
    nseg, width = acc.shape[axis], acc.shape[1 - axis]
    nnz = 40
    dest = torch.from_numpy(rng.integers(0, nseg - 2, nnz))  # 2 stay empty
    val = torch.from_numpy(rng.standard_normal(nnz).astype(np.float32))
    val = val.to(tdt)
    val[:3] = -0.0
    table = src = cell = coef = None
    if form == "table":
        table = torch.from_numpy(rng.standard_normal((11, width))
                                 .astype(np.float32)).to(tdt)
        src = torch.from_numpy(rng.integers(0, 11, nnz))
    else:
        cell = torch.from_numpy(rng.integers(0, width, nnz))
        coef = torch.from_numpy(rng.choice([-1.0, 0.0, 1.0, 2.5], nnz)
                                .astype(np.float32)).to(tdt)
    wave = _sparse_fold_torch(acc, dest, val, table, src, cell, coef, axis,
                              from_zero)
    ptr, ops = sparse_fold_operands(dest, nseg, val, src, cell, coef)
    assert ptr.dtype == torch.int32 and ptr.shape == (nseg + 1,)
    walk = _kernel_walk(acc, ptr, ops["val"], table, ops["src"],
                        ops["cell"], ops["coef"], axis, from_zero)
    assert_bitwise(walk, wave)
    got = sparse_fold_block(acc.clone(), dest, val, table=table, src=src,
                            cell=cell, coef=coef, axis=axis,
                            from_zero=from_zero)
    assert_bitwise(got, wave)


def _plan_cover(plan, nseg: int, width: int):
    """How often S1's launch of ``plan`` visits each segment and each
    element, as the kernel assigns them (``csrc/sparse_kernels.cu``).  The
    rows form: warp w of block (bx, by) takes segment bx·tc + w, lane x its
    element by·tj + x.  The tile form: block (bx, by) stages columns
    [bx·tc, bx·tc + tc) by rows [by·tj, by·tj + tj), each cut at its end;
    warp w walks columns w, w + 8, ... and lane x holds rows x + 32·i
    (i < 4).  A segment's index depends on (bx, warp, step) alone and an
    element's on (by, lane, slot) alone, so two exact 1-D covers make an
    exact 2-D one."""
    tc, tj, (gx, gy) = plan["tc"], plan["tj"], plan["grid"]
    segs, elems = np.zeros(nseg, np.int64), np.zeros(width, np.int64)
    warps, lanes = np.arange(8), np.arange(32)
    if plan["form"] == "rows":
        s = (np.arange(gx)[:, None] * 8 + warps).ravel()
        e = (np.arange(gy)[:, None] * 32 + lanes).ravel()
        np.add.at(segs, s[s < nseg], 1)
        np.add.at(elems, e[e < width], 1)
        return segs, elems
    s0 = np.arange(gx)[:, None, None] * tc
    c = warps[:, None] + 8 * np.arange(-(-tc // 8))          # (warp, step)
    ok = c < np.minimum(tc, nseg - s0)
    np.add.at(segs, np.broadcast_to(s0 + c, ok.shape)[ok], 1)
    j0 = np.arange(gy)[:, None, None] * tj
    r = lanes[:, None] + 32 * np.arange(4)                   # (lane, slot)
    ok = r < np.minimum(tj, width - j0)
    np.add.at(elems, np.broadcast_to(j0 + r, ok.shape)[ok], 1)
    return segs, elems


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("nseg,width", [(32768, 1025), (1, 1), (33, 1025),
                                        (4096, 512), (3, 65535 * 32)])
def test_sparse_fold_plan_covers_each_element_once(nseg, width, axis,
                                                   dtype):
    """S1's launch geometry, which only the card runs: every (segment,
    element) is visited exactly once, the grid keeps within 65535 blocks
    along y, the tile form's shared memory fits a block (227 KB) and a row
    of its tile is 128 bytes (32 float32, 64 bfloat16)."""
    tdt = DTYPES[dtype][0]
    plan = sparse_fold_plan(nseg, width, axis, tdt)
    segs, elems = _plan_cover(plan, nseg, width)
    assert np.all(segs == 1) and np.all(elems == 1)
    assert plan["grid"][1] <= 65535 and plan["smem"] <= 227 * 1024
    if axis == 0:
        assert (plan["form"], plan["tc"], plan["tj"], plan["smem"]) == (
            "rows", 8, 32, 0)
    else:
        assert plan["form"] == "tile"
        assert plan["tc"] * tdt.itemsize == 128
        assert 1 <= plan["tj"] <= 128
        assert plan["smem"] == 4 * (plan["tj"] * 33 + plan["tc"] + 1)
        assert plan["grid"][1] == -(-width // 128)   # tiles of equal height


def test_sparse_fold_plan_refusals():
    plan = sparse_fold_plan(2, 65535 * 32, 0, torch.float32)
    assert plan["grid"] == (1, 65535)
    for args, what in (((2, 65535 * 32 + 1, 0, torch.float32), "65535"),
                       ((2, 65535 * 32 + 1, 1, torch.bfloat16), "65535"),
                       ((0, 4, 1, torch.float32), "outside"),
                       ((4, 4, 2, torch.float32), "axis"),
                       ((4, 4, 0, torch.float64), "dtype")):
        with pytest.raises(ValueError, match=what):
            sparse_fold_plan(*args)


def test_sparse_csr_is_stable():
    dest = torch.tensor([3, 1, 3, 0, 1, 3])
    order, ptr = sparse_csr(dest, 5)
    assert order.tolist() == [3, 1, 4, 0, 2, 5]
    assert ptr.tolist() == [0, 1, 3, 3, 6, 6]
    order, ptr = sparse_csr(torch.zeros(0, dtype=torch.int64), 3)
    assert order.numel() == 0 and ptr.tolist() == [0, 0, 0, 0]


def test_sparse_fold_block_refuses_mixed_forms_and_dtypes():
    acc = torch.zeros(4, 3)
    dest = torch.tensor([0, 1])
    val = torch.ones(2)
    table = torch.ones(5, 3)
    src = torch.tensor([0, 4])
    with pytest.raises(ValueError, match="table and src"):
        sparse_fold_block(acc, dest, val, table=table)
    with pytest.raises(ValueError, match="table and src"):
        sparse_fold_block(acc, dest, val, table=table, src=src,
                          cell=src, coef=val)
    with pytest.raises(ValueError, match="cast the entries"):
        sparse_fold_block(acc, dest, val.double(), table=table, src=src)
    with pytest.raises(ValueError, match="cast the entries"):
        sparse_fold_block(acc, dest, val, table=table.bfloat16(), src=src)


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

LANE_SEEDS = (11, 99, 5)
LANE_NNZ = (13, 29, 1)
LANE_ROW0 = [0, 16, 24]


@pytest.mark.parametrize("kind", ["countsketch", "rowsample", "normal"])
def test_service_sparse_lane_vs_solo_bitwise(kind):
    """update_sparse_batch lane i == update_sparse of stream i on a second
    service == StreamingSketch.update_rows_sparse, bit for bit, with
    different nnz a lane and row0 given per lane; and == the reference's
    own batch."""
    rng = np.random.default_rng(4)
    Hs = [sparse_slab(rng, 8, 48, nnz) for nnz in LANE_NNZ]
    cfgs = [configs(kind, n1=32, n2=48, seed=s) for s in LANE_SEEDS]
    svc, one = SketchService(device="cpu"), SketchService(device="cpu")
    sids = [svc.open(t) for t, _ in cfgs]
    ones = [one.open(t) for t, _ in cfgs]
    svc.update_sparse_batch(sids, [SparseRows.from_dense(H.copy())
                                   for H in Hs], row0=LANE_ROW0)
    ref = jstream.SketchService()
    rids = [ref.open(j) for _, j in cfgs]
    ref.update_sparse_batch(rids, [jstream.SparseRows.from_dense(H.copy())
                                   for H in Hs], row0=LANE_ROW0)
    for i, ((t, _), H, r0) in enumerate(zip(cfgs, Hs, LANE_ROW0)):
        one.update_sparse(ones[i], SparseRows.from_dense(H.copy()), row0=r0)
        solo = StreamingSketch(t, device="cpu")
        solo.update_rows_sparse(r0, SparseRows.from_dense(H.copy()))
        lane, alone = svc._streams[sids[i]], one._streams[ones[i]]
        rst = ref._streams[rids[i]]
        for other in (alone, solo):
            assert_bitwise(lane.Y, other.Y)
            assert_bitwise(lane.W, other.W)
        assert_bitwise(lane.Y, ref._lane_Y(rst))
        assert_bitwise(lane.W, ref._lane_W(rst))
        assert lane.num_updates == alone.num_updates == 1


def test_service_sparse_counts_its_updates():
    prev = obs_metrics.set_metrics(None)
    try:
        svc = SketchService(device="cpu")
        cfg = StreamConfig(n1=32, n2=48, r=8, seed=SEED, kind="countsketch")
        a, b = svc.open(cfg), svc.open(cfg)
        sp = SparseRows.from_dense(
            sparse_slab(np.random.default_rng(6), 8, 48, 9))
        svc.update_sparse(a, sp, row0=8)
        svc.update_sparse_batch([a, b], [sp, sp], row0=0)
        counter = obs_metrics.get_metrics().counter("sketch_updates_total")
        assert counter.value(path="sparse") == 3
        assert svc.stats()["updates"] == 3
        assert svc.stats()["lane_batches"] == 0
        assert svc._streams[a].num_updates == 2
    finally:
        obs_metrics.set_metrics(prev)


def _batch_refusals(svc, sids, sp, tall):
    return {
        "distinct": (lambda: svc.update_sparse_batch([sids[0], sids[0]],
                                                     [sp, sp]),
                     "must be distinct"),
        "empty": (lambda: svc.update_sparse_batch([], []),
                  "at least one stream"),
        "payloads": (lambda: svc.update_sparse_batch(sids[:2], [sp]),
                     "need 2 payloads, got 1"),
        "signature": (lambda: svc.update_sparse_batch([sids[0], sids[2]],
                                                      [sp, sp]),
                      "one shape signature"),
        "height": (lambda: svc.update_sparse_batch(sids[:2], [sp, tall]),
                   "one slab height"),
        "row0": (lambda: svc.update_sparse_batch(sids[:2], [sp, sp],
                                                 row0=[0, 8, 16]),
                 "row0 needs 2 entries, got 3"),
        "bounds": (lambda: svc.update_sparse(sids[0], sp, row0=30),
                   "outside"),
    }


@pytest.mark.parametrize("case", ["distinct", "empty", "payloads",
                                  "signature", "height", "row0", "bounds"])
def test_service_sparse_checks_match_the_reference(case):
    """The port raises the reference's ValueError, message and all, for
    each malformed batch."""
    H = sparse_slab(np.random.default_rng(7), 8, 48, 5)
    T = sparse_slab(np.random.default_rng(8), 16, 48, 5)
    out = {}
    for pkg, svc, sr in (
            ("port", SketchService(device="cpu"), SparseRows),
            ("ref", jstream.SketchService(), jstream.SparseRows)):
        cls = StreamConfig if pkg == "port" else jstream.StreamConfig
        sids = [svc.open(cls(n1=32, n2=48, r=8, seed=s)) for s in (1, 2)]
        sids.append(svc.open(cls(n1=32, n2=48, r=4, seed=3)))
        op, match = _batch_refusals(svc, sids, sr.from_dense(H.copy()),
                                    sr.from_dense(T.copy()))[case]
        with pytest.raises(ValueError, match=match) as exc:
            op()
        out[pkg] = str(exc.value)
    if case not in ("signature", "bounds"):   # these name dtypes / tuples
        assert out["port"] == out["ref"]


def test_grid_service_refuses_sparse_payloads():
    svc = SketchService(mesh=GridGroups((1, 1, 1), 0, (0, 0, 0)),
                        device="cpu")
    sp = SparseRows.from_dense(np.ones((1, 1), np.float32))
    for op in (lambda: svc.update_sparse(0, sp),
               lambda: svc.update_sparse_batch([0], [sp])):
        with pytest.raises(NotImplementedError, match="local-mode only"):
            op()


@pytest.mark.parametrize("nnz", [0, 1, 21, 139264])
def test_sparse_payload_words_match_the_reference(nnz):
    assert sparse_payload_words(nnz) == jmodel.sparse_payload_words(nnz)
    assert sparse_payload_words(nnz) == 2.0 * nnz
    assert sparse_payload_words(21) == 42.0
