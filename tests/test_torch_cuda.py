"""The CUDA kernels of repro_torch against their plain torch versions.

These run only where there is a CUDA card and ``nvcc`` (they skip
elsewhere); the module imports no jax so that it runs on a machine with
the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: Omega draws are bitwise.  GEMM results are held to
``rtol=1e-5`` and ``atol=1e-5·max|ref|`` in float32 (the kernel and
``torch.matmul`` sum in different orders); bfloat16 outputs to one
bfloat16 ulp (both round the same f32 value, which may sit on either side
of a rounding boundary).  The row-slab fold is one add per element and is
held bitwise, and so is each lane of the service's ragged update against
the solo update of its stream.  The dense GEMM (K5) is held to
``16·sqrt(K)·2**-24`` relative Frobenius in float32 (two f32 sums of K
terms in different orders) and to ``2**-12`` when its output is bfloat16
(both sides round one f32 value); each of its paths (thin for K <= 16,
skinny split-K, tiled) must give the same bits twice, also into views of
a larger buffer at any start, which it must leave untouched.  The redesigned ``sketch_t`` is held to its plain version at
the float32 tolerance above; where its output is bfloat16 and K is long,
two f32 sums of K terms differ by more than one bfloat16 ulp of the
elements near zero, so there the output is held bitwise to the kernel's
own f32 product plus ``acc`` rounded once (the epilogue's contract), and
to one ulp of the plain version where K is short.  Its split form must
give the same bits twice.  The redesigned ``sketch_fwd`` is held the same
way, and its rows computed at two different m must have the same bits
(its split and its path depend on (n, K) alone).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.sketch import _omega_tile_torch, omega_tile
from repro_torch.kernels import (LAUNCHES, fold_rows_block, gemm_block,
                                 reset_launches, sketch_block, sketch_t_block)
from repro_torch.kernels.local import (_fold_rows_torch, _gemm_block_torch,
                                       _sketch_block_torch,
                                       _sketch_t_block_torch)
from repro_torch.kernels.sketch_matmul import (
    FOLD_LANE_CAPACITY, KernelLaunchError, _fold_call_struct, _fold_check,
    _fold_launch, _fold_pack, fold_rows_cuda, fold_rows_plan, sketch_fwd_plan,
    sketch_t_splits)
from repro_torch.stream import SketchService, StreamConfig, StreamingSketch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref):
    got = got.float().cpu().numpy()
    ref = ref.float().cpu().numpy()
    atol = 1e-5 * max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol)


def _within_bf16_ulp(got, ref):
    got = got.float().cpu().numpy()
    ref = ref.float().cpu().numpy()
    mag = np.maximum(np.abs(got), np.abs(ref))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - ref) <= ulp)


@pytest.mark.parametrize("kind", ["normal", "uniform", "rademacher"])
@pytest.mark.parametrize("row0,col0", [(0, 0), (2 ** 32 - 7, 5)])
def test_gen_omega_bitwise(dev, kind, row0, col0):
    got = omega_tile(2 ** 40 + 3, row0, col0, 37, 19, kind, salt=2,
                     device=dev)
    ref = _omega_tile_torch(3, 2 ** 8, row0, col0, 37, 19, kind, 2, None,
                            None, dev)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("kind", ["normal", "rademacher"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_acc", [False, True])
def test_sketch_kernels_match_plain(dev, kind, dt, use_acc):
    g = torch.Generator(device=dev).manual_seed(1)
    m, k, cols = 133, 70, 45                 # ragged against every tile
    A = torch.randn(m, k, generator=g, device=dev).to(dt)
    kw = dict(row0=11, col0=3, kind=kind, salt=1, scale=0.5)
    for kernel, plain, X, shape in (
            (sketch_block, _sketch_block_torch, A, (m, cols)),
            (sketch_t_block, _sketch_t_block_torch, A, (cols, k))):
        acc = (torch.randn(*shape, generator=g, device=dev).to(dt)
               if use_acc else None)
        ref = plain(X, 77, cols, acc=acc, **kw)
        got = kernel(X, 77, cols, acc=None if acc is None else acc.clone(),
                     **kw)
        (_close if dt == torch.float32 else _within_bf16_ulp)(got, ref)


def test_stream_launches_kernels_and_rows_are_bitwise(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    A = torch.randn(96, 80, generator=g, device=dev)
    cfg = StreamConfig(96, 80, r=24, seed=9)
    reset_launches()
    st = StreamingSketch(cfg)
    for r0 in range(0, 96, 40):
        st.update_rows(r0, A[r0:r0 + 40])
    assert LAUNCHES["sketch_fwd"] == 3 and LAUNCHES["sketch_t"] == 3
    one_shot = sketch_block(A, 9, 24)
    assert torch.equal(st.Y, one_shot)
    _close(st.W, _sketch_t_block_torch(A, 9, cfg.sketch_l, salt=1))


def _bits(x):
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("ydt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ddt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lanes", [1, 9])
def test_fold_rows_kernel_bitwise_vs_plain(dev, ydt, ddt, masked, lanes):
    g = torch.Generator(device=dev).manual_seed(3)
    m, k, c = 70, 13, 45                  # c not a multiple of 32
    y = torch.randn(lanes, m, c, generator=g, device=dev).to(ydt)
    y[:, ::3] = -0.0                      # resident -0.0 rows
    d = torch.randn(lanes, k, c, generator=g, device=dev).to(ddt)
    starts = [(m - 5 + 17 * i) % (m + k + 9) - 4 for i in range(lanes)]
    starts[0] = m + k + 50                # outside [0, m + k]: clamped
    nvalid = None
    if masked:
        nvalid = [(5 + 3 * i) % (k + 1) for i in range(lanes)]
        for i, nv in enumerate(nvalid):
            d[i, nv:] = float("nan")      # dead rows are never read
    want = _fold_rows_torch(y, d, starts, nvalid)
    ys = [y[i].clone() for i in range(lanes)]
    reset_launches()
    fold_rows_block(ys, d, starts, nvalid)
    torch.cuda.synchronize()
    assert LAUNCHES["fold_rows"] == 1
    assert torch.equal(_bits(torch.stack(ys)), _bits(want))


def _fold_case(dev, lanes, m, k, c, ydt, ddt, masked, seed):
    """(y stack, d, starts, nvalid) with resident -0.0 rows, starts outside
    [0, m + k] and NaN in d's dead rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn(lanes, m, c, generator=g, device=dev).to(ydt)
    y[:, ::3] = -0.0
    d = torch.randn(lanes, k, c, generator=g, device=dev).to(ddt)
    gen = np.random.default_rng(seed)
    starts = gen.integers(-k, m + 2 * k, lanes).tolist()
    starts[0] = m + k + 50
    nvalid = None
    if masked:
        nvalid = gen.integers(0, k + 1, lanes).tolist()
        nvalid[-1] = k
        for i, nv in enumerate(nvalid):
            d[i, nv:] = float("nan")
    return y, d, starts, nvalid


def _fold_path(ys, d, m, k, c, starts, nvalid):
    """The vector width the wrapper picks for this call."""
    ptrs = [y.data_ptr() for y in ys]
    plan, _ = _fold_pack(ys[0].dtype, d, m, k, c, ptrs, starts, nvalid)
    return plan["vec"]


# (c, lane offset): c = 128 (the service's r) and 100 (c % 4 == 0, a bf16
# row 200 bytes) take the vector path; c = 45 and a lane that is a view at
# an odd element take the one-element path
FOLD_PATHS = [(128, None, 4), (100, None, 4), (45, None, 1), (128, 1, 1),
              (100, 3, 1)]


@pytest.mark.parametrize("c,offset,vec", FOLD_PATHS)
@pytest.mark.parametrize("ydt,ddt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("masked", [False, True])
def test_fold_rows_vector_and_scalar_paths_bitwise(dev, c, offset, vec, ydt,
                                                   ddt, masked):
    lanes, m, k = 7, 300, 40
    y, d, starts, nvalid = _fold_case(dev, lanes, m, k, c, ydt, ddt, masked,
                                      c + (offset or 0))
    want = _fold_rows_torch(y, d, starts, nvalid)
    ys = [y[i].clone() for i in range(lanes)]
    if offset is not None:                       # lane 2: a view at offset
        buf = torch.full((offset + m * c + 5,), 7.0, dtype=ydt, device=dev)
        ys[2] = buf[offset:offset + m * c].view(m, c)
        ys[2].copy_(y[2])
    assert _fold_path(ys, d, m, k, c, starts, nvalid) == vec
    reset_launches()
    fold_rows_block(ys, d, starts, nvalid)
    torch.cuda.synchronize()
    assert LAUNCHES["fold_rows"] == 1
    assert torch.equal(_bits(torch.stack(ys)), _bits(want))
    if offset is not None:                       # nothing around it moved
        assert (buf[:offset] == 7).all() and (buf[offset + m * c:] == 7).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lanes", [FOLD_LANE_CAPACITY + 1,
                                   2 * FOLD_LANE_CAPACITY + 3])
def test_fold_rows_lanes_above_capacity_bitwise(dev, masked, lanes):
    """A bucket of more lanes than one parameter block holds runs as the
    plan's launches, bitwise."""
    m, k, c = 64, 16, 128
    y, d, starts, nvalid = _fold_case(dev, lanes, m, k, c, torch.float32,
                                      torch.float32, masked, lanes)
    if masked:                 # every launch has a live row
        for a in range(0, lanes, FOLD_LANE_CAPACITY):
            i = min(a + 1, lanes - 1)
            starts[i], nvalid[i] = m - 3, k
    want = _fold_rows_torch(y, d, starts, nvalid)
    ys = [y[i].clone() for i in range(lanes)]
    plan = fold_rows_plan(lanes, m, k, c, torch.float32, torch.float32, True)
    assert plan["launches"] == -(-lanes // FOLD_LANE_CAPACITY) > 1
    reset_launches()
    fold_rows_block(ys, d, starts, nvalid)
    torch.cuda.synchronize()
    assert LAUNCHES["fold_rows"] == plan["launches"]
    assert torch.equal(_bits(torch.stack(ys)), _bits(want))


def _fold_rejects(dev):
    """(name, ys, d, start, nvalid, message) the launcher must refuse."""
    m, k, c, f32 = 20, 4, 8, torch.float32
    ys = [torch.zeros(m, c, device=dev) for _ in range(3)]
    d = torch.zeros(3, k, c, device=dev)
    st, nv = [20, 21, 22], [4, 4, 4]
    wide = torch.zeros(m, 2 * c, device=dev)
    return [
        ("d_not_3d", ys, d[0], st, nv, r"d must be \(lanes=3"),
        ("d_lanes", ys, d[:2], st, nv, r"d must be \(lanes=3"),
        ("d_on_cpu", ys, d.cpu(), st, nv, "CUDA tensor"),
        ("d_float64", ys, d.double(), st, nv, "CUDA tensor"),
        ("d_strided", ys, torch.zeros(3, k, 2 * c, device=dev)[..., ::2],
         st, nv, "CUDA tensor"),
        ("y_shape", [ys[0], ys[1], torch.zeros(m + 1, c, device=dev)], d,
         st, nv, "every y must be"),
        ("y_dtype_mixed", [ys[0], ys[1].bfloat16(), ys[2]], d, st, nv,
         "every y must be"),
        ("y_strided", [ys[0], wide[:, ::2], ys[2]], d, st, nv,
         "every y must be"),
        ("y_on_cpu", [ys[0], ys[1].cpu(), ys[2]], d, st, nv,
         "every y must be"),
        ("y_float64", [y.double() for y in ys], d, st, nv,
         "y must be float32 or bfloat16"),
        ("start_count", ys, d, st[:2], nv, "need 3 start/nvalid"),
        ("nvalid_count", ys, d, st, nv + [1], "need 3 start/nvalid"),
        ("start_int32", ys, d, [20, 2 ** 31, 22], nv, "exceed int32"),
        ("nvalid_int32", ys, d, st, [4, -2 ** 31 - 1, 4], "exceed int32"),
        ("lanes_65536", [ys[0]] * 65536,
         torch.zeros(65536, 1, c, dtype=f32, device=dev), [0] * 65536,
         None, "more than 65535 lanes"),
    ]


@pytest.mark.parametrize("case", range(15))
def test_fold_rows_rejects_what_the_kernel_does_not_take(dev, case):
    """Every input the launcher refused before its redesign is refused with
    the same message, before anything launches or is written."""
    name, ys, d, start, nvalid, msg = _fold_rejects(dev)[case]
    before = [y.clone() for y in ys[:3]]
    reset_launches()
    with pytest.raises(ValueError, match=msg):
        fold_rows_cuda(ys, d, start, nvalid)
    torch.cuda.synchronize()
    assert LAUNCHES["fold_rows"] == 0, name
    assert all(torch.equal(a, b) for a, b in zip(before, ys[:3])), name


def test_fold_rows_refused_launch_raises(dev):
    """rt_fold_rows refuses a vector launch for a lane off its access
    boundary: the wrapper raises KernelLaunchError and counts nothing."""
    m, k, c = 16, 4, 8
    buf = torch.zeros(m * c + 1, device=dev)
    ys = [torch.zeros(m, c, device=dev), buf[1:].view(m, c)]
    d = torch.zeros(2, k, c, device=dev)
    lanes = _fold_check(ys, d, [m, m], [k, k])
    plan, _ = _fold_pack(torch.float32, d, *lanes)
    assert plan["vec"] == 1
    _, _, _, ptrs, starts, nvalids = lanes
    forged = _fold_call_struct(2).pack(d.data_ptr(), 2, m, k, c, k, 1, 4,
                                       plan["rows"], 0, 0, *ptrs, *starts,
                                       *nvalids)
    reset_launches()
    with pytest.raises(KernelLaunchError):
        _fold_launch(d, [forged])
    assert LAUNCHES["fold_rows"] == 0


def test_fold_rows_moves_no_metadata(dev):
    """The lanes reach the kernel through its parameter block: a call puts
    the fold kernel on the card and no copy, and allocates nothing."""
    from torch.profiler import ProfilerActivity, profile
    lanes, m, k, c = 64, 512, 64, 128
    y, d, starts, nvalid = _fold_case(dev, lanes, m, k, c, torch.float32,
                                      torch.float32, True, 5)
    ys = [y[i].clone() for i in range(lanes)]
    fold_rows_block(ys, d, starts, nvalid)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fold_rows_block(ys, d, starts, nvalid)
        torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == allocated
    names = [e.key for e in prof.key_averages() if e.device_time_total > 0]
    assert any("fold_rows_kernel" in n for n in names), names
    assert not any("memcpy" in n.lower() for n in names), names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_service_ragged_lanes_bitwise_equal_solo_on_card(dev, dtype):
    rng = np.random.default_rng(4)
    cfgs = [StreamConfig(n1=300, n2=96, r=20, seed=50 + i, dtype=dtype)
            for i in range(6)]
    svc, ref = SketchService(), SketchService()
    sids = [svc.open(c) for c in cfgs]
    rids = [ref.open(c) for c in cfgs]
    items = []
    for i, c in enumerate(cfgs):
        k = int(rng.integers(1, 70))
        items.append((i, rng.standard_normal((k, 96)).astype(np.float32),
                      int(rng.integers(0, c.n1 - k + 1))))
    for i, H, row0 in items:
        ref.update(rids[i], H, row0=row0)
    reset_launches()
    svc.update_ragged([(sids[i], H, row0) for i, H, row0 in items],
                      pad_value=float("nan"))
    svc.sync()
    assert LAUNCHES["fold_rows"] >= 1
    assert LAUNCHES["sketch_fwd"] == 6 and LAUNCHES["sketch_t"] == 6
    for s, r in zip(sids, rids):
        assert torch.equal(_bits(svc.sketch(s)), _bits(ref.sketch(r)))
        assert torch.equal(_bits(svc.corange(s)), _bits(ref.corange(r)))


# (M, N, K, A transposed, offset): offset None gives acc and out as tensors
# of their own; an offset o makes them views starting o elements into a
# larger contiguous buffer (o = N: the row-offset view big[1:]; with N odd
# or o = 1 or 2 their base is off the thin kernel's 16-byte (f32) and
# 8-byte (bf16) boundary, so it moves one element at a time).  The thin
# shapes take A transposed, as the column-major Q of torch.linalg.qr is.
GEMM_SHAPES = [
    (8, 2304, 20000, True, None),    # call (a): P^T·M, split over K
    (13, 100, 3000, True, None),     # skinny, ragged
    (1000, 77, 8, False, None),      # calls (b)/(c): K = r, A row-major
    (130, 70, 45, False, None),      # tiled, ragged against 64 x 64 x 16
] + [(M, N, K, True, None) for K in (1, 8, 16) for M in (5, 1000, 4099)
     for N in (77, 2304, 2305)] + [
    (1000, 77, 8, True, 77),         # big[1:] with N odd
    (4099, 2305, 16, True, 2305),
    (1000, 2304, 8, True, 1),        # N % 4 == 0, base off by one element
    (1000, 2304, 16, True, 2),       # 8 bytes (f32) / 4 bytes (bf16) off
    (1000, 2304, 8, True, 4),        # 16 bytes (f32) / 8 bytes (bf16) on
]


def _at(dev, src, offset, dtype):
    """(buffer, view): ``src`` copied into a view starting ``offset``
    elements into a buffer of ``dtype`` whose other entries are 7."""
    M, N = src.shape
    buf = torch.full((offset + M * N + 3,), 7.0, dtype=dtype, device=dev)
    view = buf[offset:offset + M * N].view(M, N)
    view.copy_(src)
    return buf, view


@pytest.mark.parametrize("M,N,K,trans_a,offset", GEMM_SHAPES)
@pytest.mark.parametrize("alpha", [1.0, -1.0, 0.5])
@pytest.mark.parametrize("use_acc", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gemm_kernel_matches_plain(dev, M, N, K, trans_a, offset, alpha,
                                   use_acc, out_dtype):
    g = torch.Generator(device=dev).manual_seed(5)
    A = (torch.randn(K, M, generator=g, device=dev).T if trans_a
         else torch.randn(M, K, generator=g, device=dev))
    B = torch.randn(K, N, generator=g, device=dev)
    acc = (torch.randn(M, N, generator=g, device=dev).to(out_dtype)
           if use_acc else None)
    ref = _gemm_block_torch(A, B, alpha, acc, out_dtype)

    def call():
        if offset is None:
            return None, gemm_block(A, B, alpha=alpha, out_dtype=out_dtype,
                                    acc=None if acc is None else acc.clone())
        buf, view = _at(dev, torch.zeros(M, N) if acc is None else acc,
                        offset, out_dtype)
        got = (gemm_block(A, B, alpha=alpha, acc=view, out_dtype=out_dtype)
               if use_acc else
               gemm_block(A, B, alpha=alpha, out=view, out_dtype=out_dtype))
        assert got.data_ptr() == view.data_ptr()
        return buf, got

    reset_launches()
    buf, got = call()
    _, again = call()
    torch.cuda.synchronize()
    assert LAUNCHES["gemm"] == 2
    assert got.dtype == out_dtype and tuple(got.shape) == (M, N)
    assert torch.equal(_bits(got), _bits(again))        # deterministic
    if buf is not None:                                  # nothing else moved
        rest = torch.cat([buf[:offset], buf[offset + M * N:]])
        assert bool((rest == 7).all())
    err = float(torch.linalg.norm(got.float() - ref.float())
                / torch.linalg.norm(ref.float()))
    tol = 16 * K ** 0.5 * 2.0 ** -24 if out_dtype == torch.float32 \
        else 2.0 ** -12
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("case", ["acc_f32", "out_bf16_view"])
def test_gemm_kernel_in_place_error_feedback(dev, case):
    """Call (c): M <- M - P·Q_loc^T with the accumulator as the output;
    and call (b) as the exchange makes it, P·Q^T rounded to bf16 into a
    view of a larger tensor (the gradient's storage) through out=."""
    g = torch.Generator(device=dev).manual_seed(6)
    P = torch.randn(5000, 8, generator=g, device=dev)
    Qt = torch.randn(8, 300, generator=g, device=dev)
    if case == "acc_f32":
        M = torch.randn(5000, 300, generator=g, device=dev)
        ref = _gemm_block_torch(P, Qt, -1.0, M)
        out = gemm_block(P, Qt, alpha=-1.0, acc=M)
        torch.cuda.synchronize()
        assert out.data_ptr() == M.data_ptr()
        err = float(torch.linalg.norm(M - ref) / torch.linalg.norm(ref))
        assert err <= 16 * 8 ** 0.5 * 2.0 ** -24
        return
    P = torch.linalg.qr(P).Q                 # column-major, as the exchange's
    big = torch.full((3, 5000, 300), 7.0, dtype=torch.bfloat16, device=dev)
    view = big[1]
    ref = _gemm_block_torch(P, Qt, out_dtype=torch.bfloat16)
    out = gemm_block(P, Qt, out_dtype=torch.bfloat16, out=view)
    torch.cuda.synchronize()
    assert out.data_ptr() == view.data_ptr() and out.dtype == torch.bfloat16
    assert bool((big[0] == 7).all()) and bool((big[2] == 7).all())
    err = float(torch.linalg.norm(view.float() - ref.float())
                / torch.linalg.norm(ref.float()))
    assert err <= 2.0 ** -12


# (m, n, K) of sketch_t: one split, split 8 and 16 ways (the Nystrom C's
# 16 tiles), and rows of 70 columns (280 bytes: no 16-byte copies)
SKETCH_T_SHAPES = {
    "one_split": ((1025, 1930, 4099), 1),
    "split_ragged": ((1025, 300, 4099), 8),
    "split_c": ((512, 512, 16384), 16),
    "unaligned": ((45, 70, 133), 1),
}


def _offset_view(dev, rows, cols, dt, offset, seed):
    """A (rows, cols) operand of ``dt`` as a view starting ``offset``
    elements into a larger buffer (an odd offset leaves its base off 16
    bytes, as a ragged lane's ``Hb[i, :k]`` may)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randn(rows * cols + offset, generator=g, device=dev).to(dt)
    return buf[offset:].view(rows, cols)


@pytest.mark.parametrize("shape", list(SKETCH_T_SHAPES))
@pytest.mark.parametrize("dt_in", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dt_out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_acc", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
def test_sketch_t_redesign_matches_plain(dev, shape, dt_in, dt_out, use_acc,
                                         offset):
    (m, n, K), splits = SKETCH_T_SHAPES[shape]
    assert sketch_t_splits(m, n, K) == splits
    B = _offset_view(dev, K, n, dt_in, offset, 12)
    assert B.is_contiguous() and B.storage_offset() == offset
    kw = dict(row0=2 ** 32 - 300, col0=2 ** 31, kind="normal", salt=2)
    g = torch.Generator(device=dev).manual_seed(13)
    acc = (torch.randn(m, n, generator=g, device=dev).to(dt_out)
           if use_acc else None)
    reset_launches()
    dot = sketch_t_block(B, 77, m, out_dtype=torch.float32, **kw)
    acc_in = None if acc is None else acc.clone()
    got = sketch_t_block(B, 77, m, acc=acc_in, out_dtype=dt_out, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["sketch_t"] == 2 and LAUNCHES["gen_omega"] == 0
    assert got.dtype == dt_out and tuple(got.shape) == (m, n)
    if use_acc:
        assert got.data_ptr() == acc_in.data_ptr()     # updated in place
    _close(dot, _sketch_t_block_torch(B, 77, m, out_dtype=torch.float32,
                                      **kw))
    want = (dot if acc is None else acc.float() + dot).to(dt_out)
    assert torch.equal(_bits(got), _bits(want))         # acc + dot, once
    ref = _sketch_t_block_torch(B, 77, m, acc=acc, out_dtype=dt_out, **kw)
    if dt_out == torch.float32:
        _close(got, ref)
    elif K < 1000:
        _within_bf16_ulp(got, ref)


@pytest.mark.parametrize("dt_in", [torch.float32, torch.bfloat16])
def test_sketch_t_split_is_deterministic(dev, dt_in):
    (m, n, K), splits = SKETCH_T_SHAPES["split_c"]
    assert splits > 1
    B = _offset_view(dev, K, n, dt_in, 0, 14)
    runs = [sketch_t_block(B, 5, m, row0=3, salt=1,
                           out_dtype=torch.float32) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(_bits(runs[0]), _bits(runs[1]))


# (m, K, n) of sketch_fwd with its (path, splits): the tiled kernel without
# a split, a serving lane split 16 ways, the narrow kernel with K longer
# than one shared-memory chunk (3072 rows at r = 8), and rows of 70
# columns over a K that is not a multiple of 4
SKETCH_FWD_SHAPES = {
    "wide": ((1000, 4099, 333), ("wide", 1)),
    "serving_split": ((200, 8192, 128), ("wide", 16)),
    "narrow": ((3001, 9216, 8), ("narrow", 1)),
    "unaligned": ((45, 133, 70), ("wide", 1)),
}
FWD_KW = dict(row0=2 ** 32 - 300, col0=2 ** 31, kind="normal", salt=2)


@pytest.mark.parametrize("shape", list(SKETCH_FWD_SHAPES))
@pytest.mark.parametrize("dt_in", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dt_out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_acc", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
def test_sketch_fwd_redesign_matches_plain(dev, shape, dt_in, dt_out,
                                           use_acc, offset):
    (m, K, n), (path, splits) = SKETCH_FWD_SHAPES[shape]
    plan = sketch_fwd_plan(m, n, K)
    assert (plan["path"], plan["splits"]) == (path, splits)
    A = _offset_view(dev, m, K, dt_in, offset, 15)
    assert A.is_contiguous() and A.storage_offset() == offset
    g = torch.Generator(device=dev).manual_seed(16)
    acc = (torch.randn(m, n, generator=g, device=dev).to(dt_out)
           if use_acc else None)
    reset_launches()
    dot = sketch_block(A, 77, n, out_dtype=torch.float32, **FWD_KW)
    acc_in = None if acc is None else acc.clone()
    got = sketch_block(A, 77, n, acc=acc_in, out_dtype=dt_out, **FWD_KW)
    torch.cuda.synchronize()
    assert LAUNCHES["sketch_fwd"] == 2 and LAUNCHES["gen_omega"] == 0
    assert got.dtype == dt_out and tuple(got.shape) == (m, n)
    if use_acc:
        assert got.data_ptr() == acc_in.data_ptr()     # updated in place
    _close(dot, _sketch_block_torch(A, 77, n, out_dtype=torch.float32,
                                    **FWD_KW))
    want = (dot if acc is None else acc.float() + dot).to(dt_out)
    assert torch.equal(_bits(got), _bits(want))         # acc + dot, once
    ref = _sketch_block_torch(A, 77, n, acc=acc, out_dtype=dt_out, **FWD_KW)
    if dt_out == torch.float32:
        _close(got, ref)
    elif K < 1000:
        _within_bf16_ulp(got, ref)


@pytest.mark.parametrize("shape", ["serving_split", "narrow", "wide"])
@pytest.mark.parametrize("dt_in", [torch.float32, torch.bfloat16])
def test_sketch_fwd_rows_do_not_depend_on_m(dev, shape, dt_in):
    """Two runs give the same bits, and the rows of a shorter call (into
    an ``out=`` view, as a ragged lane writes its dY) the bits of the
    same rows of the whole call."""
    (m, K, n), _ = SKETCH_FWD_SHAPES[shape]
    A = _offset_view(dev, m, K, dt_in, 1, 17)
    runs = [sketch_block(A, 5, n, row0=3, salt=1, out_dtype=torch.float32)
            for _ in range(2)]
    dYb = torch.full((2, 80, n), float("nan"), device=dev)
    for k in (1, 37, 64):
        view = dYb[1, :k]
        got = sketch_block(A[m - k:], 5, n, row0=3, salt=1,
                           out_dtype=torch.float32, out=view)
        assert got.data_ptr() == view.data_ptr()
        torch.cuda.synchronize()
        assert torch.equal(_bits(view), _bits(runs[0][m - k:]))
    assert torch.isnan(dYb[0]).all() and torch.isnan(dYb[1, 64:]).all()
    assert torch.equal(_bits(runs[0]), _bits(runs[1]))


def test_alg1_four_ranks_on_one_card_match_the_one_device_sketch(dev):
    """Alg. 1 on 4 gloo ranks that share cuda:0: each rank's B block
    against the same rows and columns of the one-device card sketch,
    bitwise on (4, 1, 1) (no collective; the same kernel on the same rows)
    and within 16·sqrt(K)·2**-24 relative Frobenius on (2, 2, 1) (the
    reduce-scatter sums two partials of K = n2/2); words received equal
    the paper's formula; every rank launched sketch_fwd."""
    from repro_torch.core.grid import alg1_bandwidth_words
    from torch_dist_helper import alg1_card_worker, run_workers
    n1, n2, r = 1024, 2048, 64
    grids = [(4, 1, 1), (2, 2, 1)]
    ranks = run_workers(alg1_card_worker, 4, n1, n2, r, 7, grids)
    for rank, res in enumerate(ranks):
        for grid in grids:
            bitwise, err, words, launches, where = res[grid]
            assert where == "cuda" and launches == 1, (rank, grid)
            assert words == alg1_bandwidth_words(n1, n2, r, *grid)
            if grid == (4, 1, 1):
                assert bitwise and words == 0, (rank, err)
            else:
                assert err <= 16 * np.sqrt(n2 // 2) * 2.0 ** -24, (rank, err)


def test_alg2_1d_four_ranks_on_one_card(dev):
    """The 1-D Alg. 2 on 4 gloo ranks that share cuda:0 (n = 1024, r =
    64): B is bitwise the one-device card sketch's rows (No-Redist: the
    same kernel on the same rows) or columns (Redist: the all-to-all is a
    layout move); C within 16·sqrt(n)·2**-24 relative Frobenius of the
    one-device ``sketch_t``; words received exactly (1 - 1/P)·r² and
    (1 - 1/P)·n·r/P; one sketch_fwd and one sketch_t launch a run, no
    gen_omega, and the result on the card."""
    from torch_dist_helper import alg2_card_worker, run_workers
    n, r, P = 1024, 64, 4
    ranks = run_workers(alg2_card_worker, P, n, r, 7)
    words = {"no_redist": (P - 1) * r * r // P,
             "redist": (P - 1) * n * r // P ** 2}
    for rank, res in enumerate(ranks):
        for variant, want in words.items():
            bitwise, err, got, launches, where = res[variant]
            assert where == ("cuda", "cuda"), (rank, variant)
            assert bitwise, (rank, variant)
            assert err <= 16 * np.sqrt(n) * 2.0 ** -24, (rank, variant, err)
            assert got == want, (rank, variant, got)
            assert launches == {"sketch_fwd": 1, "sketch_t": 1,
                                "gen_omega": 0}, (rank, variant, launches)


def _two_grid_words(n, r, p, q, rank):
    """Words ``rank`` receives in one two-grid run, by kind: Alg. 1's on
    p, its q-block less what its p-block held, the q2 all-gather and the
    q1 reduce-scatter."""
    p1, p2, p3 = p
    q1, q2, q3 = q
    i, j, k = np.unravel_index(rank, p)
    iq, jq, kq = np.unravel_index(rank, q)
    held = np.zeros((n, r), bool)
    rows, cols = n // (p1 * p2), r // p3
    held[(i * p2 + j) * rows:(i * p2 + j + 1) * rows,
         k * cols:(k + 1) * cols] = True
    want = np.zeros((n, r), bool)
    rows, cols = n // q1, r // (q2 * q3)
    want[iq * rows:(iq + 1) * rows,
         (kq * q2 + jq) * cols:(kq * q2 + jq + 1) * cols] = True
    return {"all_gather": (p3 - 1) * n * n // (p1 * p2 * p3)
            + (q2 - 1) * n * r // (q1 * q2 * q3),
            "reduce_scatter": (p2 - 1) * n * r // (p1 * p2 * p3)
            + (q1 - 1) * r * r // (q1 * q2 * q3),
            "all_reduce": 0, "all_to_all": 0,
            "redistribute": int(want.sum() - (want & held).sum())}


def test_alg2_two_grid_four_ranks_on_one_card(dev):
    """The two-grid Alg. 2 on 4 gloo ranks that share cuda:0 (n = 1024,
    r = 64, and the regime-2 pair at r = 2), the Redistribute an uneven
    all-to-all of CUDA tensors: B bitwise the one-device card sketch's
    q-block where p = (4, 1, 1) (the same kernel on the same rows, then a
    layout move), within 16·sqrt(n)·2**-24 relative Frobenius elsewhere;
    C within that of the one-device ``sketch_t``'s block; words received
    exactly, by kind; one sketch_fwd and one sketch_t launch a run, no
    gen_omega, and the result on the card."""
    from torch_dist_helper import run_workers, two_grid_card_worker
    n, P = 1024, 4
    runs = [((4, 1, 1), (1, 1, 4), 64), ((4, 1, 1), (1, 2, 2), 64),
            ((4, 1, 1), (2, 1, 2), 64), ((2, 2, 1), (4, 1, 1), 64),
            ((4, 1, 1), (2, 1, 2), 2)]
    ranks = run_workers(two_grid_card_worker, P, n, 7, runs)
    tol = 16 * np.sqrt(n) * 2.0 ** -24
    for rank, res in enumerate(ranks):
        for p, q, r in runs:
            bitwise, err_b, err_c, words, launches, where = res[(p, q, r)]
            what = (rank, p, q, r)
            assert where == ("cuda", "cuda"), what
            assert bitwise if p == (4, 1, 1) else err_b <= tol, what
            assert err_c <= tol, (what, err_c)
            assert words == _two_grid_words(n, r, p, q, rank), (what, words)
            assert launches == {"sketch_fwd": 1, "sketch_t": 1,
                                "gen_omega": 0}, (what, launches)


def test_stream_distributed_four_ranks_on_one_card(dev):
    """The sharded stream on 4 gloo ranks that share cuda:0 (n = 1024,
    r = 64, slabs of 128 rows in reverse order): on (4, 1, 1) Y is bitwise
    this rank's ``rand_matmul`` block and W a one-device stream's, with 0
    words a slab; on (2, 2, 1) ``update_rows`` is bitwise ``update`` on Y
    and a slab receives ``stream_update_cost``'s words; the redist
    finalize's C is bitwise the second stage on the one-shot blocks; every
    rank launched sketch_fwd, sketch_t and fold_rows, and no gen_omega."""
    from repro_torch.plan.model import stream_update_cost
    from torch_dist_helper import run_workers, stream_dist_card_worker
    n, r, slab = 1024, 64, 128
    ranks = run_workers(stream_dist_card_worker, 4, n, r, slab, 7)
    for rank, res in enumerate(ranks):
        y_ok, w_ok, rows_eq_full, words, c_ok, launches, where = res
        assert where == ("cuda", "cuda"), rank
        assert y_ok and w_ok and rows_eq_full and c_ok, (rank, res)
        assert words[(4, 1, 1)] == {0}, (rank, words)
        assert words[(2, 2, 1)] == {stream_update_cost(
            slab, n, r, 2 * r + 1, grid=(2, 2, 1)).words}, (rank, words)
        assert all(launches[k] > 0 for k in ("sketch_fwd", "sketch_t",
                                             "fold_rows")), (rank, launches)
        assert launches["gen_omega"] == 0, (rank, launches)


# ---------------------------------------------------------------------------
# S1, the sparse fold of COO row slabs: bitwise, one rounding at each
# product and each add, in entry order
# ---------------------------------------------------------------------------

def _sparse_bits(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def _sparse_fold_case(dtype, form, axis, seed=0):
    """An odd-shaped acc (37 x 45), one segment with 300 entries, two with
    none, -0.0 in acc and val, entries in no order."""
    rng = np.random.default_rng(seed)
    acc = torch.from_numpy(rng.standard_normal((37, 45)).astype(np.float32))
    acc = acc.to(dtype)
    acc[0, :3] = -0.0
    nseg, width = acc.shape[axis], acc.shape[1 - axis]
    dest = np.concatenate([rng.integers(0, nseg - 2, 500),
                           np.full(300, 3)])
    dest = torch.from_numpy(rng.permutation(dest))
    nnz = dest.numel()
    val = torch.from_numpy(rng.standard_normal(nnz).astype(np.float32))
    val = val.to(dtype)
    val[:4] = -0.0
    ops = {}
    if form == "table":
        ops["table"] = torch.from_numpy(rng.standard_normal(
            (61, width)).astype(np.float32)).to(dtype)
        ops["src"] = torch.from_numpy(rng.integers(0, 61, nnz))
    else:
        ops["cell"] = torch.from_numpy(rng.integers(0, width, nnz))
        ops["coef"] = torch.from_numpy(rng.choice(
            [-1.0, 0.0, 1.0, 3.5], nnz).astype(np.float32)).to(dtype)
    return acc, dest, val, ops


@pytest.mark.parametrize("from_zero", [True, False])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("form", ["table", "cell"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_fold_bitwise_plain(dev, dtype, form, axis, from_zero):
    from repro_torch.kernels import sparse_fold_block
    from repro_torch.kernels.local import _sparse_fold_torch
    acc, dest, val, ops = _sparse_fold_case(dtype, form, axis)
    ops_d = {k: v.to(dev) for k, v in ops.items()}
    ref = _sparse_fold_torch(acc, dest, val, axis=axis, from_zero=from_zero,
                             **ops)
    runs = []
    for _ in range(2):
        reset_launches()
        got = sparse_fold_block(acc.to(dev), dest.to(dev), val.to(dev),
                                axis=axis, from_zero=from_zero, **ops_d)
        torch.cuda.synchronize()
        assert LAUNCHES["sparse_fold"] == 1
        runs.append(got.cpu())
    assert torch.equal(_sparse_bits(runs[0]), _sparse_bits(ref))
    assert torch.equal(_sparse_bits(runs[1]), _sparse_bits(runs[0]))


_NAN_BITS = {torch.float32: (0x7FC00001, -0x3FFFFF),      # 0xFFC00001
             torch.bfloat16: (0x7FC1, -0x3F)}              # 0xFFC1


def _sparse_tile_case(dtype, form, axis, from_zero, long_nnz, seed=3):
    """S1's tile edges: 100 segments of 1025 elements (nseg not a multiple
    of the tile's 32 or 64 columns, one row past 32·32), entries only in
    segments 0-31 and 96-99, so segments 32-95 are tiles with no entry
    (float32) or untouched columns of a touched tile (bfloat16); segment 5
    holds ``long_nnz`` entries; -0.0 and NaN bits (two payloads, both
    signs) in untouched segments and, for the cell form, in element 1024
    of touched ones, which no entry names.  NaN is left out where the
    fold must rewrite every element (``from_zero``): the card's NaN
    arithmetic gives other bits than the CPU's."""
    rng = np.random.default_rng(seed)
    nseg, width = 100, 1025
    shape = (nseg, width) if axis == 0 else (width, nseg)
    acc = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    acc = acc.to(dtype)
    seg = acc if axis == 0 else acc.T              # a view: [segment, element]
    seg[40, :7] = -0.0
    seg[3, 9] = -0.0
    if not from_zero:
        ib = seg.view(torch.int32 if dtype == torch.float32 else torch.int16)
        for s in (33, 70):
            ib[s, 0], ib[s, 1000] = _NAN_BITS[dtype]
        if form == "cell":
            ib[:, width - 1] = _NAN_BITS[dtype][0]
    dest = np.concatenate([rng.integers(0, 32, 3000), np.full(long_nnz, 5),
                           rng.integers(96, 100, 500)])
    dest = torch.from_numpy(rng.permutation(dest))
    nnz = dest.numel()
    val = torch.from_numpy(rng.standard_normal(nnz).astype(np.float32))
    val = val.to(dtype)
    val[:4] = -0.0
    ops = {}
    if form == "table":
        ops["table"] = torch.from_numpy(rng.standard_normal(
            (257, width)).astype(np.float32)).to(dtype)
        ops["src"] = torch.from_numpy(rng.integers(0, 257, nnz))
    else:
        ops["cell"] = torch.from_numpy(rng.integers(0, width - 1, nnz))
        ops["coef"] = torch.from_numpy(rng.choice(
            [-1.0, 0.0, 1.0, 3.5], nnz).astype(np.float32)).to(dtype)
    return acc, dest, val, ops


_SPARSE_EDGES = [(dt, form, axis, fz, 4096)
                 for dt in (torch.float32, torch.bfloat16)
                 for form in ("table", "cell") for axis in (0, 1)
                 for fz in (True, False)]
_SPARSE_EDGES += [(dt, form, axis, fz, 65536)
                  for dt in (torch.float32, torch.bfloat16)
                  for form in ("table", "cell")
                  for axis, fz in ((1, False), (0, True))]


@pytest.mark.parametrize("dtype,form,axis,from_zero,long_nnz", _SPARSE_EDGES)
def test_sparse_fold_tile_edges_bitwise_plain(dev, dtype, form, axis,
                                              from_zero, long_nnz):
    """Both forms of S1 at the tile's edges (``_sparse_tile_case``), every
    setting with a segment of 4096 entries and the stream's two settings
    (W: columns into itself; Y: rows from zero) with one of 65,536 (2,048
    prefetched chunks of 32): bitwise the plain version and run to run,
    one launch a fold."""
    from repro_torch.kernels import sparse_fold_block
    from repro_torch.kernels.local import _sparse_fold_torch
    acc, dest, val, ops = _sparse_tile_case(dtype, form, axis, from_zero,
                                            long_nnz)
    ref = _sparse_fold_torch(acc, dest, val, axis=axis, from_zero=from_zero,
                             **ops)
    ops_d = {k: v.to(dev) for k, v in ops.items()}
    runs = []
    for _ in range(2):
        reset_launches()
        got = sparse_fold_block(acc.to(dev), dest.to(dev), val.to(dev),
                                axis=axis, from_zero=from_zero, **ops_d)
        torch.cuda.synchronize()
        assert LAUNCHES["sparse_fold"] == 1
        runs.append(got.cpu())
    assert torch.equal(_sparse_bits(runs[0]), _sparse_bits(ref))
    assert torch.equal(_sparse_bits(runs[1]), _sparse_bits(runs[0]))


def test_sparse_fold_refuses_a_plan_that_does_not_fit(dev):
    """rt_sparse_fold checks the launch it is handed against the call."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.sketch_matmul import (SPARSE_FOLD_FORMS,
                                                   _stream, sparse_fold_plan)
    acc = torch.zeros(1025, 100, device=dev)
    ptr = torch.zeros(101, dtype=torch.int32, device=dev)
    table = torch.zeros(1, 1025, device=dev)
    plan = sparse_fold_plan(100, 1025, 1, torch.float32)
    lib = _build.library()

    def call(form, tc, tj, smem, grid):
        return lib.rt_sparse_fold(
            acc.data_ptr(), 0, 100, 1025, 0, 1, 100, ptr.data_ptr(), None,
            table.data_ptr(), None, None, None, 0, SPARSE_FOLD_FORMS[form],
            tc, tj, smem, *grid, _stream(dev))

    good = (plan["form"], plan["tc"], plan["tj"], plan["smem"], plan["grid"])
    assert call(*good) == 0
    torch.cuda.synchronize()
    for bad in (("rows", 8, 32, 0, (13, 33)),
                ("tile", 64, plan["tj"], plan["smem"], plan["grid"]),
                ("tile", 32, plan["tj"], plan["smem"] - 4, plan["grid"]),
                ("tile", 32, plan["tj"], plan["smem"],
                 (plan["grid"][0], plan["grid"][1] - 1))):
        assert call(*bad) != 0, bad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["normal", "uniform", "rademacher",
                                  "countsketch", "rowsample"])
def test_update_rows_sparse_card_bitwise_cpu(dev, kind, dtype):
    """The card's stream (S1, the draws on the card) against the CPU's
    plain stream, which the CPU tests hold bitwise to the reference: an
    odd n2, empty rows, a column with no entry and one with many, two
    slabs (the second onto a nonzero W) and an empty payload."""
    from repro_torch.stream import SparseRows
    cfg = StreamConfig(n1=40, n2=45, r=8, seed=7, kind=kind, dtype=dtype)
    rng = np.random.default_rng(1)
    slabs = []
    for _ in range(2):
        row = np.concatenate([rng.integers(0, 12, 150), np.full(60, 5)])
        col = np.concatenate([rng.integers(0, 44, 150), np.full(60, 9)])
        val = rng.standard_normal(210).astype(np.float32)
        order = rng.permutation(210)
        slabs.append(SparseRows(row[order].astype(np.int32),
                                col[order].astype(np.int32), val[order],
                                (16, 45)))
    slabs.append(SparseRows(np.zeros(0, np.int32), np.zeros(0, np.int32),
                            np.zeros(0, np.float32), (16, 45)))
    card = [StreamingSketch(cfg, device=dev) for _ in range(2)]
    cpu = StreamingSketch(cfg, device="cpu")
    for row0, sp in zip((0, 24, 8), slabs):
        reset_launches()
        card[0].update_rows_sparse(row0, sp)
        torch.cuda.synchronize()
        dense = kind in ("normal", "uniform", "rademacher")
        assert LAUNCHES["sparse_fold"] == (1 if sp.nnz == 0 else 2)
        assert LAUNCHES["gen_omega"] == (2 if dense else 0)
        card[1].update_rows_sparse(row0, sp)
        cpu.update_rows_sparse(row0, sp)
        for st in card:
            assert torch.equal(_sparse_bits(st.Y.cpu()), _sparse_bits(cpu.Y))
            assert torch.equal(_sparse_bits(st.W.cpu()), _sparse_bits(cpu.W))
    assert torch.all(cpu.W[:, 44] == 0)     # column 44 has no entry


@pytest.mark.parametrize("kind", ["countsketch", "normal"])
def test_service_sparse_lane_vs_solo_on_the_card(dev, kind):
    from repro_torch.stream import SparseRows
    rng = np.random.default_rng(4)
    svc, one = SketchService(device=dev), SketchService(device=dev)
    sps, cfgs = [], []
    for seed, nnz in zip((11, 99, 5), (13, 29, 1)):
        H = np.zeros((8, 48), np.float32)
        H.flat[rng.choice(8 * 48, size=nnz, replace=False)] = (
            rng.standard_normal(nnz).astype(np.float32))
        sps.append(SparseRows.from_dense(H))
        cfgs.append(StreamConfig(n1=32, n2=48, r=8, seed=seed, kind=kind))
    sids = [svc.open(c) for c in cfgs]
    ones = [one.open(c) for c in cfgs]
    row0s = [0, 16, 24]
    reset_launches()
    svc.update_sparse_batch(sids, sps, row0=row0s)
    torch.cuda.synchronize()
    assert LAUNCHES["sparse_fold"] == 2 * len(sids)
    for i, (c, sp, r0) in enumerate(zip(cfgs, sps, row0s)):
        one.update_sparse(ones[i], sp, row0=r0)
        solo = StreamingSketch(c, device=dev).update_rows_sparse(r0, sp)
        lane = svc._streams[sids[i]]
        for other in (one._streams[ones[i]], solo):
            assert torch.equal(_sparse_bits(lane.Y), _sparse_bits(other.Y))
            assert torch.equal(_sparse_bits(lane.W), _sparse_bits(other.W))


def test_probe_machine_on_the_card(dev):
    """The card's machine entry and kind tag: an H100 gets the H100 entry
    (any other card must be refused, not mapped onto it)."""
    from repro_torch.plan import (H100_GLOO, PRESETS, device_kind_tag,
                                  probe_machine)
    name = torch.cuda.get_device_name(0)
    assert device_kind_tag() == device_kind_tag(dev) == name.replace(" ",
                                                                     "_")
    if "H100" in name:
        assert probe_machine() is PRESETS[H100_GLOO]
        assert probe_machine(dev) is PRESETS[H100_GLOO]
    else:
        with pytest.raises(ValueError, match="machine="):
            probe_machine()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_auto_edge_round_bitwise_equal_solo_on_card(dev, dtype):
    """One round through ``make_ingest_queue(bucket_edges="auto")``: the
    planner's edges for the round's heights on the card's entry, every
    lane bitwise the solo update of its stream."""
    from repro_torch.plan import choose_bucket_edges, probe_machine
    from repro_torch.serve import make_ingest_queue
    rng = np.random.default_rng(6)
    cfgs = [StreamConfig(n1=300, n2=96, r=20, seed=70 + i, dtype=dtype)
            for i in range(8)]
    svc, ref = SketchService(), SketchService()
    sids = [svc.open(c) for c in cfgs]
    rids = [ref.open(c) for c in cfgs]
    items = []
    for i, c in enumerate(cfgs):
        k = int(rng.integers(1, 70))
        items.append((i, rng.standard_normal((k, 96)).astype(np.float32),
                      int(rng.integers(0, c.n1 - k + 1))))
    ks = [H.shape[0] for _, H, _ in items]
    q = make_ingest_queue(svc, expected_ks=ks)
    assert list(q.bucket_edges) == choose_bucket_edges(
        ks, 96, 20, cfgs[0].sketch_l, machine=probe_machine(dev))
    for i, H, row0 in items:
        q.submit(sids[i], H, row0)
    q.flush(raise_errors=True)
    st = q.stats()
    q.shutdown()
    assert st["applied"] == len(items) and st["retries"] == 0
    for i, H, row0 in items:
        ref.update(rids[i], H, row0=row0)
    svc.sync()
    for s, r in zip(sids, rids):
        assert torch.equal(_bits(svc.sketch(s)), _bits(ref.sketch(r)))
        assert torch.equal(_bits(svc.corange(s)), _bits(ref.corange(r)))


@pytest.fixture
def sm90(dev):
    """The planner's card tests price on the H100 entry and run the
    kernels built for sm_90a."""
    if torch.cuda.get_device_capability(dev) != (9, 0):
        pytest.skip(f"needs an sm_90 card (the H100 entry and the sm_90a "
                    f"kernels); this is {torch.cuda.get_device_name(dev)}")
    return dev


def _planned(plan, variant):
    import dataclasses
    return dataclasses.replace(plan, variant=variant)


def test_one_card_sketch_plans_on_the_card(sm90):
    """``probe_machine()`` plans carry the H100 entry; each one-card
    sketch variant's ``execute`` is bitwise the call it names, the kernel
    variant launches ``sketch_fwd``, and the two agree at the f32
    tolerance."""
    from repro_torch.core.sketch import sketch_reference
    from repro_torch.kernels import ops
    from repro_torch.plan import H100_GLOO, plan_sketch
    g = torch.Generator(device=sm90).manual_seed(3)
    A = torch.randn(300, 520, device=sm90, generator=g)
    plan = plan_sketch(300, 520, 24, P=1)
    assert plan.machine == H100_GLOO
    assert [c.variant for c in plan.candidates][0] == plan.variant
    reset_launches()
    fused = _planned(plan, "cuda_fused").execute(A, seed=9)
    assert LAUNCHES["sketch_fwd"] == 1
    plain = _planned(plan, "local_torch").execute(A, seed=9)
    assert torch.equal(fused, ops.sketch_matmul(A, seed=9, r=24))
    assert torch.equal(plain, sketch_reference(A, 9, 24))
    assert fused.device.type == plain.device.type == "cuda"
    _close(fused, plain)


def test_one_card_nystrom_and_stream_plans_on_the_card(sm90):
    """The same for Nyström (B and C) and for a stream fed in
    ``chunk_rows`` slabs (Y and W bitwise a ``StreamingSketch`` fed the
    same slabs, Y bitwise the one-shot ``sketch_fwd``)."""
    from repro_torch.core.nystrom import nystrom_reference
    from repro_torch.kernels import ops
    from repro_torch.plan import H100_GLOO, plan_nystrom, plan_stream
    g = torch.Generator(device=sm90).manual_seed(4)
    X = torch.randn(384, 12, device=sm90, generator=g)
    S = X @ X.T
    plan = plan_nystrom(384, 32, P=1)
    assert plan.machine == H100_GLOO
    Bf, Cf = _planned(plan, "cuda_fused").execute(S, seed=5)
    Bp, Cp = _planned(plan, "local_torch").execute(S, seed=5)
    B0, C0 = ops.nystrom_fused(S, seed=5, r=32)
    B1, C1 = nystrom_reference(S, 5, 32)
    assert torch.equal(Bf, B0) and torch.equal(Cf, C0)
    assert torch.equal(Bp, B1) and torch.equal(Cp, C1)
    _close(Bf, Bp)
    _close(Cf, Cp)
    splan = plan_stream(384, 384, 32, P=1, chunk_rows=128, corange=True)
    assert (splan.machine, splan.variant) == (H100_GLOO, "stream_local")
    st = splan.execute(S, seed=5)
    ref = StreamingSketch(StreamConfig(n1=384, n2=384, r=32, seed=5))
    for row0 in range(0, 384, 128):
        ref.update_rows(row0, S[row0:row0 + 128])
    assert torch.equal(st.sketch, ref.sketch)
    assert torch.equal(st.corange_sketch, ref.corange_sketch)
    assert torch.equal(st.sketch, B0)


def test_default_timer_times_a_sleep_kernel(sm90):
    """``default_timer`` reads CUDA events on the current stream: a sleep
    kernel of twice the cycles takes twice the time, and the events see
    no more than the host clock around a synchronize does."""
    import time

    from repro_torch.plan import default_timer
    cycles = 20_000_000                     # about 10 ms at the SM clock
    one = default_timer(lambda: torch.cuda._sleep(cycles))
    two = default_timer(lambda: torch.cuda._sleep(2 * cycles))
    assert 1.8 <= two / one <= 2.2
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]
    assert 0.7 * wall <= one <= 1.05 * wall


def test_kernel_shared_memory_is_the_tile_constants(sm90):
    """``kernel_smem_bytes`` (from the tile constants of csrc/) against
    ``cudaFuncGetAttributes`` and the dynamic bytes each launcher asks
    for; every kernel fits one SM of the H100 entry."""
    from repro_torch.kernels.sketch_matmul import (kernel_smem_attributes,
                                                   kernel_smem_bytes)
    from repro_torch.plan import H100_GLOO, PRESETS
    got = kernel_smem_attributes()
    assert got == kernel_smem_bytes()
    smem = torch.cuda.get_device_properties(sm90) \
        .shared_memory_per_multiprocessor
    assert PRESETS[H100_GLOO].smem_bytes == smem
    assert all(sum(b) <= smem for b in got.values())


def test_autotune_on_the_card_executes_its_winner(sm90, tmp_path):
    """A small sketch tuned on the card with CUDA events: the winner is a
    one-card candidate, executes bitwise its direct call, and a second
    call on a new cache at the same path is a pure hit."""
    from repro_torch.core.sketch import sketch_reference
    from repro_torch.kernels import ops
    from repro_torch.plan import AutotuneCache, autotune, plan_sketch
    path = tmp_path / "tune.json"
    plan = plan_sketch(1024, 2048, 64, P=1)
    records = []
    tuned = autotune(plan, cache=str(path), records=records, presets={})
    assert sorted(r["variant"] for r in records) == ["cuda_fused",
                                                      "local_torch"]
    assert tuned.measured_seconds == min(r["seconds"] for r in records) > 0
    g = torch.Generator(device=sm90).manual_seed(5)
    A = torch.randn(1024, 2048, device=sm90, generator=g)
    direct = {"cuda_fused": lambda: ops.sketch_matmul(A, seed=7, r=64),
              "local_torch": lambda: sketch_reference(A, 7, 64)}
    assert torch.equal(tuned.execute(A, seed=7), direct[tuned.variant]())

    def forbidden(fn):
        raise AssertionError("a hit ran the timer")
    cache = AutotuneCache(path)
    hit = autotune(plan, cache=cache, timer=forbidden, presets={})
    assert cache.hits == 1 and hit.variant == tuned.variant


def _counted_kernel_calls(device):
    """The kernels' dispatches at fixed shapes, inputs made before the
    block from a numpy seed: each call's counts, ``(launches, flops,
    bytes)``, and the S1 update's launches alone (its card path builds
    its CSR with torch ops, which the CPU's plain path does inside the
    kernel's count)."""
    from repro_torch.kernels import ops
    from repro_torch.roofline import counting
    from repro_torch.stream.state import SparseRows
    rng = np.random.default_rng(32)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)
    A, B, W = t(40, 1024), t(1024, 5), t(24, 5)
    G, H, acc = t(8, 1024), t(1024, 40), t(8, 40)
    ys, d = [t(16, 8) for _ in range(3)], t(3, 4, 8)
    calls = {
        "sketch_fwd split": lambda: sketch_block(A, 7, 32),
        "sketch_fwd narrow": lambda: sketch_block(A, 7, 8),
        "sketch_t split acc": lambda: sketch_t_block(B, 7, 24, acc=W),
        "gemm skinny acc": lambda: gemm_block(G, H, alpha=-1.0, acc=acc),
        "fold_rows": lambda: fold_rows_block(ys, d, [16, 13, 40], [4, 2, 4]),
        "gen_omega": lambda: ops.gen_omega(seed=7, n2=96, r=24,
                                           device=device)}
    out = {}
    for name, fn in calls.items():
        with counting() as c:
            fn()
        out[name] = (c.launches, c.flops, c.hbm_bytes)
    cfg = StreamConfig(64, 128, r=8, seed=3)
    st = StreamingSketch(cfg, device=device)
    idx = rng.choice(16 * 128, size=200, replace=False)
    sp = SparseRows((idx // 128).astype(np.int32),
                    (idx % 128).astype(np.int32),
                    rng.standard_normal(200).astype(np.float32), (16, 128))
    with counting() as c:
        st.update_rows_sparse(16, sp)
    out["update_rows_sparse"] = c.launches
    return out


def test_roofline_counts_real_launches_as_on_the_cpu(sm90):
    """Counted on the card, each kernel dispatch's launches equal the
    launches ``LAUNCHES`` saw, and its launches, FLOPs and bytes equal the
    CPU's count of the same calls at the same shapes."""
    reset_launches()
    card = _counted_kernel_calls(sm90)
    torch.cuda.synchronize()
    launched = {k: v for k, v in LAUNCHES.items() if v}
    total = {}
    for got in card.values():
        for k, v in (got[0] if isinstance(got, tuple) else got).items():
            total[k] = total.get(k, 0) + v
    assert total == launched
    assert card == _counted_kernel_calls("cpu")
