"""Launchers of the port's CUDA kernels, with their launch counters.

The counterpart of the reference's Pallas kernel module: where that one
defines ``gen_omega_pallas``, ``sketch_matmul_pallas`` and
``sketch_t_matmul_pallas``, this one launches the hand-written Hopper
kernels of ``csrc/sketch_kernels.cu`` and ``csrc/sketch_t_kernels.cu``
that replace them, the row-slab fold of ``csrc/fold_kernels.cu``, the
dense GEMM of ``csrc/gemm_kernels.cu`` and the sparse fold of
``csrc/sparse_kernels.cu``:

  * ``gen_omega_cuda``  — a materialized Omega tile (the K1 generator's
                          oracle, K8);
  * ``sketch_fwd_cuda`` — ``acc? + A · Omega[row0:, col0:col0+cols]``
                          (K2, and K6 at offset 0): Omega drawn once a
                          call into a scratch, a narrow kernel for at most
                          16 columns, K split for one column tile;
  * ``sketch_t_cuda``   — ``acc? + Omega[row0:, col0:col0+cols]^T · B``
                          (K3, and K7 at offset 0): Omega drawn once a
                          call into a scratch, K split where the output
                          tiles do not fill the card;
  * ``fold_rows_cuda``  — ``y_i + [0; d_i; 0][start_i : start_i + m]``
                          for up to 240 lanes in one launch, their
                          metadata in its parameter block, masked to
                          ``nvalid_i`` rows (K4, the reference's
                          ``_fold_rows_pallas`` vmapped over lanes);
  * ``gemm_cuda``       — ``acc? + (A · B)·alpha`` with both operands in
                          device memory (K5, the reference's
                          ``_gemm_pallas``): a streaming thin kernel for
                          K <= 16, split over K for a skinny A, tiled
                          otherwise (``gemm_plan``);
  * ``sparse_fold_cuda`` — COO entries folded into the rows or columns of
                          an accumulator in entry order, one thread an
                          element, columns staged through shared memory
                          in 128-byte rows, no atomics (S1, the sparse
                          row slab's update, ``sparse_fold_plan``; the
                          reference's is a plain XLA scatter).

Keys, offsets, salt, kind and scale are runtime arguments, so one build
serves every seed and shard offset.  Each launcher checks device, dtype,
shape and contiguity, launches on the current stream without
synchronizing, raises :class:`KernelLaunchError` if the launch was
refused, and adds one to ``LAUNCHES[name]`` once the launch is accepted
(and nowhere else).
"""
from __future__ import annotations

import ctypes
import functools
import operator
import struct
from typing import Optional, Sequence

import torch

from . import _build

MASK32 = 0xFFFFFFFF
KIND_CODES = {"normal": 0, "uniform": 1, "rademacher": 2}
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2 ** 31 - 1

# Launches of each kernel since the last ``reset_launches()``.
LAUNCHES = {"gen_omega": 0, "sketch_fwd": 0, "sketch_t": 0,
            "fold_rows": 0, "gemm": 0, "sparse_fold": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kind_code(kind: str) -> int:
    if kind not in KIND_CODES:
        raise ValueError(f"no CUDA kernel for omega kind {kind!r}; the "
                         f"kernels draw {', '.join(KIND_CODES)}")
    return KIND_CODES[kind]


def _omega_args(key0, key1, row0, col0, salt, kind, scale):
    return (int(key0) & MASK32, int(key1) & MASK32, int(row0) & MASK32,
            int(col0) & MASK32, int(salt) & MASK32, _kind_code(kind),
            1.0 if scale is None else float(scale))


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


class KernelLaunchError(RuntimeError):
    """The card refused a kernel launch.  Not transient: callers that
    retry failed work (the ingest queue) re-raise it."""


def _launched(rc: int, name: str) -> None:
    """Raise if the launch was refused, else count it."""
    if rc != 0:
        msg = _build.library().rt_error_string(rc).decode()
        raise KernelLaunchError(f"CUDA kernel {name} failed to launch: "
                                f"error {rc} ({msg})")
    LAUNCHES[name] += 1


def _check_operand(X: torch.Tensor, name: str) -> None:
    if not X.is_cuda:
        raise ValueError(f"{name}: operand must be a CUDA tensor, got "
                         f"{X.device}")
    if X.dim() != 2 or X.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: operand must be a 2-D float32/bfloat16 "
                         f"tensor, got {tuple(X.shape)} {X.dtype}")
    if not X.is_contiguous():
        raise ValueError(f"{name}: operand must be contiguous")


def _check_like(X: torch.Tensor, shape, dtype, device, what: str,
                name: str) -> None:
    if (X.device != device or tuple(X.shape) != tuple(shape)
            or X.dtype != dtype or not X.is_contiguous()):
        raise ValueError(f"{name}: {what} must be a contiguous {dtype} "
                         f"tensor of shape {tuple(shape)} on {device}, got "
                         f"{tuple(X.shape)} {X.dtype} on {X.device}")


def _output(acc: Optional[torch.Tensor], out: Optional[torch.Tensor], shape,
            out_dtype, device, name: str) -> torch.Tensor:
    """The tensor the kernel writes: ``out`` when given (a pre-allocated
    view), else ``acc`` itself (accumulated in place), else a new one."""
    if out_dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: out_dtype must be float32 or bfloat16, "
                         f"got {out_dtype}")
    for what, X in (("acc", acc), ("out", out)):
        if X is not None:
            _check_like(X, shape, out_dtype, device, what, name)
    if out is not None:
        return out
    if acc is not None:
        return acc
    return torch.empty(shape, dtype=out_dtype, device=device)


def gen_omega_cuda(key0: int, key1: int, row0: int, col0: int, rows: int,
                   cols: int, kind: str, salt: int = 0,
                   device=None) -> torch.Tensor:
    """Omega[row0:row0+rows, col0:col0+cols] as float32, drawn on the card."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"gen_omega_cuda needs a CUDA device, got {device}")
    if not (0 <= rows <= _INT_MAX and 0 <= cols <= _INT_MAX):
        raise ValueError(f"bad tile shape ({rows}, {cols})")
    args = _omega_args(key0, key1, row0, col0, salt, kind, None)
    out = torch.empty((rows, cols), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(device):
        rc = lib.rt_gen_omega(out.data_ptr(), rows, cols, *args,
                              _stream(device))
    _launched(rc, "gen_omega")
    return out


# sketch_fwd's wide path has sketch_t's 128 x 128 output tiles
# (kBM = kBN of csrc/sketch_kernels.cu); an output of at most
# SKETCH_FWD_NARROW_N columns (its kNarrowMaxN, which refuses a split
# there) takes the narrow kernel, which streams A once and never splits.  The split count depends on (n, K) alone, never on m:
# a split changes the order of the f32 sum, and a streamed slab, a ragged
# lane or a one-shot sketch must give the same bits for the same row.
# Only a single column tile is split (n <= SKETCH_FWD_TILE: the service's
# lanes, whose k <= 256 rows leave at most 2 row tiles), into chunks of at
# least SKETCH_FWD_MIN_K_SPLIT rows and at most SKETCH_FWD_MAX_SPLITS; a
# wider output (the one-shot and streaming sketches, r = 512) is not.
SKETCH_FWD_TILE = 128
SKETCH_FWD_NARROW_N = 16
SKETCH_FWD_MIN_K_SPLIT = 512
SKETCH_FWD_MAX_SPLITS = 64


def sketch_fwd_narrow(n: int) -> bool:
    """Whether an output of ``n`` columns takes ``sketch_fwd``'s narrow
    kernel (the gradient exchange's r = 8)."""
    return n <= SKETCH_FWD_NARROW_N


def sketch_fwd_splits(n: int, K: int) -> int:
    """How many blocks share the contraction of one output tile of
    ``sketch_fwd``: 1 on the narrow path and for outputs wider than one
    tile, else ``K // SKETCH_FWD_MIN_K_SPLIT`` capped at
    ``SKETCH_FWD_MAX_SPLITS`` (16 on a serving lane, K = 8192).

    Its price, since m is not looked at: a split call needs an f32 work
    buffer of ``splits·m·n·4`` bytes (1 GiB at m = 32768, n = 128,
    K = 32768: 64 splits) and writes and reads it once more, up to about
    16% of the FMA time at 512-row splits, also at a tall m whose tiles
    would fill the card without a split."""
    if sketch_fwd_narrow(n) or n > SKETCH_FWD_TILE:
        return 1
    return max(1, min(K // SKETCH_FWD_MIN_K_SPLIT, SKETCH_FWD_MAX_SPLITS))


def sketch_fwd_scratch_bytes(n: int, K: int) -> int:
    """Bytes of the f32 scratch that one ``sketch_fwd`` call draws its Omega
    slab into: K rows of n columns, padded to a multiple of 4 (16 bytes)."""
    return K * (-(-n // 4) * 4) * 4


def sketch_fwd_plan(m: int, n: int, K: int) -> dict:
    """What one ``sketch_fwd`` call of A (m, K) -> (m, n) launches and
    allocates: its ``path`` ("narrow" or "wide"), ``splits``, and the
    bytes of its scratch and of its work buffer.  The path and the split
    depend on (n, K) alone; only the work buffer grows with m."""
    splits = sketch_fwd_splits(n, K)
    return {"path": "narrow" if sketch_fwd_narrow(n) else "wide",
            "splits": splits,
            "scratch_bytes": sketch_fwd_scratch_bytes(n, K),
            "work_bytes": splits * m * n * 4 if splits > 1 else 0}


def sketch_fwd_cuda(A: torch.Tensor, key0: int, key1: int, cols: int,
                    row0: int = 0, col0: int = 0, kind: str = "normal",
                    salt: int = 0, scale=None,
                    acc: Optional[torch.Tensor] = None,
                    out_dtype=None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc? + A @ Omega[row0:row0+k, col0:col0+cols]`` on the card.

    ``A`` (m, k) float32/bfloat16, contiguous (any start: a view into a
    larger buffer is read where it lies).  The result is written into
    ``out`` when given (a contiguous view of ``out_dtype``), else into
    ``acc`` in place, else into a new tensor.

    One call is one ctypes call and two launches on the current stream,
    three with a split: the Omega slab is drawn once into a scratch of
    :func:`sketch_fwd_scratch_bytes`, then the product runs over it — the
    narrow kernel for at most SKETCH_FWD_NARROW_N columns, else the tiled
    one, split over K by :func:`sketch_fwd_splits` into an f32 work
    buffer whose partial sums are added in split order
    (:func:`sketch_fwd_plan`).  Scratch and work
    are allocated here and released on return; the count in
    ``LAUNCHES["sketch_fwd"]`` is one a call.
    """
    name = "sketch_fwd"
    _check_operand(A, name)
    m, K = A.shape
    n = cols
    out_dtype = out_dtype or A.dtype
    args = _omega_args(key0, key1, row0, col0, salt, kind, scale)
    if (max(m, n, K) > _INT_MAX
            or -(-m // SKETCH_FWD_TILE) * -(-n // SKETCH_FWD_TILE)
            > _INT_MAX):
        raise ValueError(f"{name}: dims ({m}, {n}, {K}) exceed int32 or the "
                         f"grid")
    out = _output(acc, out, (m, n), out_dtype, A.device, name)
    if m == 0 or n == 0:
        return out
    plan = sketch_fwd_plan(m, n, K)
    splits = plan["splits"]
    scratch = torch.empty(plan["scratch_bytes"] // 4, dtype=torch.float32,
                          device=A.device)
    work = (torch.empty((splits, m, n), dtype=torch.float32, device=A.device)
            if splits > 1 else None)
    lib = _build.library()
    with torch.cuda.device(A.device):
        rc = lib.rt_sketch_fwd(A.data_ptr(),
                               None if acc is None else acc.data_ptr(),
                               out.data_ptr(), scratch.data_ptr(),
                               None if work is None else work.data_ptr(), m,
                               K, n, int(A.dtype == torch.bfloat16),
                               int(out_dtype == torch.bfloat16), splits,
                               *args, _stream(A.device))
    _launched(rc, name)
    return out


# sketch_t's 128 x 128 output tiles (kBM = kBN of csrc/sketch_t_kernels.cu)
# run two blocks of 256 threads on each of an H100's 132 SMs.  Where the
# tiles are fewer than the SMs, the contraction is split so that the grid
# reaches about two blocks an SM, never into splits of fewer than
# SKETCH_T_MIN_K_SPLIT rows and never into more than the grid's third
# dimension holds (kMaxSplits).  The split depends on (m, n, K) alone, so
# a ragged lane and its solo update, or two runs, give the same bits.
SKETCH_T_TILE = 128
SKETCH_T_SMS = 132
SKETCH_T_TARGET_BLOCKS = 2 * SKETCH_T_SMS
SKETCH_T_MIN_K_SPLIT = 512
SKETCH_T_MAX_SPLITS = 64
_SKETCH_T_MAX_TILES = 65535      # the grid's second dimension (column tiles)


def sketch_t_splits(m: int, n: int, K: int) -> int:
    """How many blocks share the contraction of one (m, n) output tile of
    ``sketch_t``: 1 unless its tiles leave SMs idle and K is long enough
    to split."""
    tiles = -(-m // SKETCH_T_TILE) * -(-n // SKETCH_T_TILE)
    if tiles >= SKETCH_T_SMS:
        return 1
    return max(1, min(SKETCH_T_TARGET_BLOCKS // tiles,
                      K // SKETCH_T_MIN_K_SPLIT, SKETCH_T_MAX_SPLITS))


def sketch_t_scratch_bytes(m: int, K: int) -> int:
    """Bytes of the f32 scratch that one ``sketch_t`` call draws its Omega
    slab into: K rows of m columns, padded to a multiple of 4 (16 bytes)."""
    return K * (-(-m // 4) * 4) * 4


def sketch_t_plan(m: int, n: int, K: int) -> dict:
    """What one ``sketch_t`` call of B (K, n) -> (m, n) allocates:
    ``splits`` (:func:`sketch_t_splits`) and the bytes of its Omega
    scratch and of its f32 work buffer (``splits·m·n·4`` when split)."""
    splits = sketch_t_splits(m, n, K)
    return {"splits": splits,
            "scratch_bytes": sketch_t_scratch_bytes(m, K),
            "work_bytes": splits * m * n * 4 if splits > 1 else 0}


def sketch_t_cuda(B: torch.Tensor, key0: int, key1: int, cols: int,
                  row0: int = 0, col0: int = 0, kind: str = "normal",
                  salt: int = 0, scale=None,
                  acc: Optional[torch.Tensor] = None,
                  out_dtype=None) -> torch.Tensor:
    """``acc? + Omega[row0:row0+k, col0:col0+cols]^T @ B`` on the card.

    ``B`` (k, r2) float32/bfloat16, contiguous (any start: a view into a
    larger buffer is read where it lies); the result is (cols, r2),
    written into ``acc`` in place when given, else into a new tensor.

    One call is one ctypes call and two launches on the current stream,
    three with a split: the Omega slab is drawn once into a scratch of
    :func:`sketch_t_scratch_bytes`, the product runs over it (split over
    K by :func:`sketch_t_splits` into an f32 work buffer), and a split's
    partial sums are added in split order (:func:`sketch_t_plan`).
    Scratch and work are allocated here and released on return; the count
    in ``LAUNCHES["sketch_t"]`` is one a call.
    """
    name = "sketch_t"
    _check_operand(B, name)
    K, n = B.shape
    m = cols
    out_dtype = out_dtype or B.dtype
    args = _omega_args(key0, key1, row0, col0, salt, kind, scale)
    if (max(m, n, K) > _INT_MAX
            or -(-n // SKETCH_T_TILE) > _SKETCH_T_MAX_TILES):
        raise ValueError(f"{name}: dims ({m}, {n}, {K}) exceed int32 or the "
                         f"grid")
    out = _output(acc, None, (m, n), out_dtype, B.device, name)
    if m == 0 or n == 0:
        return out
    plan = sketch_t_plan(m, n, K)
    splits = plan["splits"]
    scratch = torch.empty(plan["scratch_bytes"] // 4, dtype=torch.float32,
                          device=B.device)
    work = (torch.empty((splits, m, n), dtype=torch.float32, device=B.device)
            if splits > 1 else None)
    lib = _build.library()
    with torch.cuda.device(B.device):
        rc = lib.rt_sketch_t(B.data_ptr(),
                             None if acc is None else acc.data_ptr(),
                             out.data_ptr(), scratch.data_ptr(),
                             None if work is None else work.data_ptr(), K, n,
                             m, int(B.dtype == torch.bfloat16),
                             int(out_dtype == torch.bfloat16), splits, *args,
                             _stream(B.device))
    _launched(rc, name)
    return out


# K4's launch (``rt_fold_rows`` of csrc/fold_kernels.cu) carries its lanes'
# y pointers, starts and nvalids in the kernel's parameter block, at most
# FOLD_LANE_CAPACITY lanes (its kLaneCap; 16 bytes a lane inside the 4 KB
# block); a bucket of more lanes is several launches.  A block covers
# FOLD_BLOCK_SLOTS vector slots a pass (kThreads x kUnroll), whole rows of
# one lane; a slot is FOLD_VEC columns when every base is 16-byte aligned
# and c % FOLD_VEC == 0, else one.
FOLD_LANE_CAPACITY = 240
FOLD_BLOCK_SLOTS = 1024
FOLD_VEC = 4


def fold_rows_plan(lanes: int, m: int, k: int, c: int, y_dtype, d_dtype,
                   aligned: bool) -> dict:
    """What one ``fold_rows`` call of ``lanes`` (m, c) y's and a (lanes, k,
    c) d launches: the vector width ``vec`` (FOLD_VEC columns an access
    when ``aligned`` — every y base and d's base a multiple of 16 bytes —
    and c % FOLD_VEC == 0, else 1), the ``rows`` a block covers and the
    number of ``launches`` (FOLD_LANE_CAPACITY lanes each).  Raises
    ValueError for a dtype the kernel does not take and for sizes past
    int32 (or more than 65535 lanes)."""
    if y_dtype not in KERNEL_DTYPES or d_dtype not in KERNEL_DTYPES:
        raise ValueError(f"fold_rows: y and d must be float32 or bfloat16, "
                         f"got {y_dtype} and {d_dtype}")
    if max(m, k, c, lanes) > _INT_MAX or lanes > 65535:
        raise ValueError("fold_rows: sizes or offsets exceed int32 (or more "
                         "than 65535 lanes)")
    vec = FOLD_VEC if aligned and c % FOLD_VEC == 0 else 1
    return {"vec": vec, "rows": max(1, FOLD_BLOCK_SLOTS // -(-c // vec)),
            "launches": -(-lanes // FOLD_LANE_CAPACITY)}


_T = torch.Tensor
_SHAPE, _DTYPE = operator.attrgetter("shape"), operator.attrgetter("dtype")


def _fold_check(ys: Sequence[torch.Tensor], d: torch.Tensor, start,
                nvalid) -> Optional[tuple]:
    """fold_rows_cuda's checks, each a C-level pass over the lanes: (m, k,
    c, y pointers, starts, nvalids or None), or None when there is nothing
    to launch.  Raises ValueError for what the kernel does not take."""
    name = "fold_rows"
    n = len(ys)
    dshape = d.shape
    if len(dshape) != 3 or dshape[0] != n:
        raise ValueError(f"{name}: d must be (lanes={n}, k, c), got "
                         f"{tuple(dshape)}")
    _, k, c = dshape
    if not d.is_cuda or d.dtype not in KERNEL_DTYPES or not d.is_contiguous():
        raise ValueError(f"{name}: d must be a contiguous float32/bfloat16 "
                         f"CUDA tensor, got {d.dtype} on {d.device}")
    if n == 0:
        return None
    m = ys[0].shape[0]
    shape, dt, dev = (m, c), ys[0].dtype, d.get_device()
    count = operator.countOf
    if (count(map(_SHAPE, ys), shape) != n or count(map(_DTYPE, ys), dt) != n
            or not all(map(_T.is_contiguous, ys))
            or count(map(_T.get_device, ys), dev) != n):
        for y in ys:                      # raises at the first bad lane
            _check_like(y, shape, dt, d.device, "every y", name)
    if dt not in KERNEL_DTYPES:
        raise ValueError(f"{name}: y must be float32 or bfloat16, got {dt}")
    starts = list(map(int, start))
    nvalids = None if nvalid is None else list(map(int, nvalid))
    if len(starts) != n or (nvalids is not None and len(nvalids) != n):
        raise ValueError(f"{name}: need {n} start/nvalid entries")
    words = (starts,) if nvalids is None else (starts, nvalids)
    if (max(m, k, c, n) > _INT_MAX or n > 65535
            or min(map(min, words)) < -2 ** 31
            or max(map(max, words)) > _INT_MAX):
        raise ValueError(f"{name}: sizes or offsets exceed int32 (or more "
                         f"than 65535 lanes)")
    if nvalids is not None and max(nvalids) <= 0:
        return None
    return m, k, c, list(map(_T.data_ptr, ys)), starts, nvalids


@functools.lru_cache(maxsize=None)
def _fold_call_struct(n: int) -> struct.Struct:
    """``rt_fold_rows``'s call record for n lanes: its FoldCall header
    (d's address; n, m, k, c, span, masked, vec, rows, y_bf16, d_bf16),
    then n uint64 y pointers, n int32 starts and n int32 nvalids."""
    return struct.Struct(f"<Q10i{n}Q{2 * n}i")


def _fold_pack(y_dtype, d: torch.Tensor, m: int, k: int, c: int, ptrs,
               starts, nvalids) -> tuple:
    """The plan and one packed call record (host bytes) for each launch of
    at most FOLD_LANE_CAPACITY lanes, d's address advanced by whole lanes;
    a launch whose lanes change no row is left out."""
    n, d_ptr = len(ptrs), d.data_ptr()
    aligned = not (functools.reduce(operator.or_, ptrs, d_ptr) & 15)
    plan = fold_rows_plan(n, m, k, c, y_dtype, d.dtype, aligned)
    masked = nvalids is not None
    flags = (int(masked), plan["vec"], plan["rows"],
             int(y_dtype == torch.bfloat16), int(d.dtype == torch.bfloat16))
    cap, lane_bytes = FOLD_LANE_CAPACITY, k * c * d.element_size()
    nvs = nvalids if masked else [0] * n
    calls = []
    for a in range(0, n, cap):
        nv = nvs[a:a + cap]
        span = min(m, max(nv)) if masked else m
        if span > 0:
            calls.append(_fold_call_struct(len(nv)).pack(
                d_ptr + a * lane_bytes, len(nv), m, k, c, span, *flags,
                *ptrs[a:a + cap], *starts[a:a + cap], *nv))
    return plan, calls


def _fold_launch(d: torch.Tensor, calls) -> None:
    """One ``rt_fold_rows`` call (one launch, counted) per call record, on
    the current stream of d's card."""
    idx = d.get_device()
    if torch.cuda.current_device() != idx:
        with torch.cuda.device(idx):
            return _fold_launch(d, calls)
    lib = _build.library()
    stream = torch._C._cuda_getCurrentRawStream(idx)   # current_stream's
    for call in calls:
        _launched(lib.rt_fold_rows(call, stream), "fold_rows")


def fold_rows_cuda(ys: Sequence[torch.Tensor], d: torch.Tensor,
                   start: Sequence[int],
                   nvalid: Optional[Sequence[int]] = None) -> None:
    """``ys[i] <- ys[i] + [0_m; d[i]; 0_m][start[i] : start[i] + m]`` for
    every lane i, in place: ONE launch for up to FOLD_LANE_CAPACITY lanes.

    ``ys``: the lanes' y, each a contiguous (m, c) float32/bfloat16
    tensor, all of one shape and dtype on one card (separate allocations:
    nothing is stacked; any start, the pointers are read at every call).
    ``d``: a contiguous (lanes, k, c) float32/bfloat16 tensor.  ``start``
    and ``nvalid`` are host integers, one per lane; with ``nvalid`` the
    fold is masked (rows not fed by the first ``nvalid[i]`` rows of
    ``d[i]`` keep their exact bits).  They reach the kernel with the lane
    pointers through the launch's parameter block (no device metadata, no
    host-to-device copy); nothing is read back.  The sum is taken in f32
    and rounded once to y's dtype.  A bucket of more lanes runs as
    :func:`fold_rows_plan`'s launches on the current stream, each counted
    in ``LAUNCHES["fold_rows"]``.
    """
    lanes = _fold_check(ys, d, start, nvalid)
    if lanes is None:
        return
    _, calls = _fold_pack(ys[0].dtype, d, *lanes)
    _fold_launch(d, calls)


# The path of a K5 call is chosen by its shape (``gemm_plan``), and
# ``rt_gemm`` of csrc/gemm_kernels.cu takes the code of GEMM_PATHS that it
# names (its kPathTiled / kPathSkinny / kPathThin).  A contraction of at
# most GEMM_THIN_K (its kThinMaxK) takes the thin kernel, a streaming pass
# over acc and out, at any M; else a skinny A (at most GEMM_SKINNY_M rows)
# takes the split-K kernel, whose split count aims at GEMM_TARGET_BLOCKS
# blocks (8 a streaming multiprocessor of an H100) without giving a split
# fewer than GEMM_MIN_K_SPLIT rows of B; else the tiled kernel.
GEMM_PATHS = {"tiled": 0, "skinny": 1, "thin": 2}
GEMM_THIN_K = 16
GEMM_SKINNY_M = 32
GEMM_TARGET_BLOCKS = 132 * 8
GEMM_MIN_K_SPLIT = 512
_GEMM_SKINNY_COLS = 128          # kSkinnyCols of csrc/gemm_kernels.cu


def gemm_splits(M: int, N: int, K: int) -> int:
    """How many blocks share the K loop of one output column tile of the
    skinny kernel: 1 unless A is skinny (``M <= GEMM_SKINNY_M``) and K long
    enough to split (at least ``2·GEMM_MIN_K_SPLIT``, so never on the thin
    path); the splits' partial sums are added in split order."""
    if M > GEMM_SKINNY_M:
        return 1
    tiles = -(-N // _GEMM_SKINNY_COLS)
    return max(1, min(-(-GEMM_TARGET_BLOCKS // tiles), K // GEMM_MIN_K_SPLIT,
                      65535))


def gemm_plan(M: int, N: int, K: int) -> dict:
    """What one ``gemm`` call of (M, K)·(K, N) launches and allocates: its
    ``path`` ("thin" for K <= GEMM_THIN_K, else "skinny" for
    M <= GEMM_SKINNY_M, else "tiled"), ``splits`` (:func:`gemm_splits`;
    above 1 only on the skinny path) and the bytes of its f32 work buffer.
    The exchange's calls (b) and (c) (K = r) take "thin", call (a)
    (M = r, K = m) "skinny"."""
    if K <= GEMM_THIN_K:
        path = "thin"
    elif M <= GEMM_SKINNY_M:
        path = "skinny"
    else:
        path = "tiled"
    splits = gemm_splits(M, N, K)
    return {"path": path, "splits": splits,
            "work_bytes": splits * M * N * 4 if splits > 1 else 0}


def gemm_cuda(A: torch.Tensor, B: torch.Tensor, alpha: float = 1.0,
              acc: Optional[torch.Tensor] = None, out_dtype=None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc? + (A @ B)·alpha`` on the card, summed in f32 and cast once to
    ``out_dtype`` (default float32).

    ``A`` (M, K) float32, any strides (a transposed view, or the
    column-major Q of ``torch.linalg.qr``, is read as it is); ``B`` (K, N)
    float32, contiguous.  The result is written into ``out`` when given,
    else into ``acc`` in place when given (both contiguous (M, N) of
    ``out_dtype``, at any start; ``out`` may be ``acc``), else into a new
    tensor.  The kernel is the one :func:`gemm_plan` names: for K <= 16 the
    thin kernel, which streams acc and out with 16-byte (f32) or 8-byte
    (bf16) accesses where N % 4 == 0 and both start on such a boundary,
    else one element at a time; for a skinny A the K loop split over
    blocks, the partial sums added in a fixed order by a second pass (one
    more kernel on the stream, counted with the first as one launch); else
    the tiled kernel.  Every path sums each element in the same order, so
    two runs give the same bits.
    """
    name = "gemm"
    for what, X in (("A", A), ("B", B)):
        if not X.is_cuda or X.dim() != 2 or X.dtype != torch.float32:
            raise ValueError(f"{name}: {what} must be a 2-D float32 CUDA "
                             f"tensor, got {tuple(X.shape)} {X.dtype} on "
                             f"{X.device}")
    if not B.is_contiguous():
        raise ValueError(f"{name}: B must be contiguous")
    if A.device != B.device:
        raise ValueError(f"{name}: A on {A.device}, B on {B.device}")
    M, K = A.shape
    if B.shape[0] != K:
        raise ValueError(f"{name}: inner dims differ, A {tuple(A.shape)} "
                         f"B {tuple(B.shape)}")
    N = B.shape[1]
    if max(M, N, K) > _INT_MAX:
        raise ValueError(f"{name}: dims ({M}, {N}, {K}) exceed int32")
    out_dtype = out_dtype or torch.float32
    dst = _output(acc, out, (M, N), out_dtype, A.device, name)
    if M == 0 or N == 0:
        return dst
    plan = gemm_plan(M, N, K)
    splits = plan["splits"]
    work = (torch.empty((splits, M, N), dtype=torch.float32, device=A.device)
            if splits > 1 else None)
    lib = _build.library()
    with torch.cuda.device(A.device):
        rc = lib.rt_gemm(A.data_ptr(), B.data_ptr(),
                         None if acc is None else acc.data_ptr(),
                         dst.data_ptr(),
                         None if work is None else work.data_ptr(), M, N, K,
                         A.stride(0), A.stride(1), GEMM_PATHS[plan["path"]],
                         splits, float(alpha),
                         int(out_dtype == torch.bfloat16), _stream(A.device))
    _launched(rc, name)
    return dst


SPARSE_FOLD_FORMS = {"rows": 0, "tile": 1}
SPARSE_WARPS = 8            # warps a block, both forms
SPARSE_ROW_BYTES = 128      # a row of the tile form: one 128-byte line
SPARSE_TILE_ROWS = 128      # most elements of a segment a tile holds
SPARSE_PITCH_WORDS = 33     # a tile row in shared memory, one word padding
SPARSE_GRID_Y = 65535


def sparse_fold_plan(nseg: int, width: int, axis: int, dtype) -> dict:
    """What one S1 launch over ``nseg`` segments of ``width`` elements of an
    acc of ``dtype`` takes: its ``form``, ``tc`` segments and ``tj``
    elements a block, the dynamic shared ``smem`` bytes and the ``grid``
    (segments' blocks, elements' blocks).

    Segments along axis 0 are contiguous rows: the "rows" form puts a warp
    on 32 elements of one segment and a block on SPARSE_WARPS segments.
    Segments along axis 1 are columns, strided by the row length: the
    "tile" form stages ``tc`` consecutive columns (one 128-byte row of the
    tile: 32 float32 or 64 bfloat16) by ``tj`` rows in shared memory,
    padded to SPARSE_PITCH_WORDS words a row, with the tile's ``tc + 1``
    CSR offsets after it; the rows are cut into ceil(width / 128) tiles of
    equal height (at most SPARSE_TILE_ROWS).  Block (bx, by) covers
    segments [bx·tc, (bx + 1)·tc) and elements [by·tj, (by + 1)·tj), each
    cut at its end.  Raises ValueError for a dtype the kernel does not
    take, another axis, sizes past int32 or width past 65535 blocks of 32.
    """
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"sparse_fold: dtype must be float32 or bfloat16, "
                         f"got {dtype}")
    if axis not in (0, 1):
        raise ValueError(f"sparse_fold: axis must be 0 or 1, got {axis}")
    if min(nseg, width) < 1 or max(nseg, width) > _INT_MAX \
            or -(-width // 32) > SPARSE_GRID_Y:
        raise ValueError(f"sparse_fold: sizes ({nseg}, {width}) outside "
                         f"[1, int32] or past {SPARSE_GRID_Y} blocks of 32")
    if axis == 0:
        form, tc, tj, smem = "rows", SPARSE_WARPS, 32, 0
    else:
        form = "tile"
        tc = SPARSE_ROW_BYTES // dtype.itemsize
        tj = -(-width // -(-width // SPARSE_TILE_ROWS))
        smem = 4 * (tj * SPARSE_PITCH_WORDS + tc + 1)
    return {"form": form, "tc": tc, "tj": tj, "smem": smem,
            "grid": (-(-nseg // tc), -(-width // tj))}


def sparse_fold_cuda(acc: torch.Tensor, ptr: torch.Tensor, val: torch.Tensor,
                     table: Optional[torch.Tensor] = None,
                     src: Optional[torch.Tensor] = None,
                     cell: Optional[torch.Tensor] = None,
                     coef: Optional[torch.Tensor] = None, axis: int = 0,
                     from_zero: bool = False) -> torch.Tensor:
    """S1 (``csrc/sparse_kernels.cu``): fold CSR-ordered COO entries into
    the segments of ``acc`` IN PLACE — its rows (``axis=0``) or its columns
    (``axis=1``) — walking each segment's entries in order and rounding to
    acc's type at each product and each add.

    ``ptr`` (int32, ``acc.shape[axis] + 1``) delimits each segment's
    entries; ``val`` and the entry arrays are in that (CSR) order.  The
    dense form adds ``val[e]·table[src[e], :]`` along the segment, the
    sparse form ``val[e]·coef[e]`` at position ``cell[e]`` of it.  With
    ``from_zero`` each segment's sum starts at 0 and every segment becomes
    ``acc + sum`` (one rounding); else the sum starts at acc and a segment
    with no entries is left untouched.  Indices must lie in range (the
    caller validates them).  One launch of the form
    :func:`sparse_fold_plan` names, counted under ``"sparse_fold"``; none
    when there is nothing to change (no entries, not ``from_zero``).
    """
    name = "sparse_fold"
    if not acc.is_cuda or acc.dim() != 2 or acc.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: acc must be a 2-D float32/bfloat16 CUDA "
                         f"tensor, got {tuple(acc.shape)} {acc.dtype} on "
                         f"{acc.device}")
    if not acc.is_contiguous():
        raise ValueError(f"{name}: acc must be contiguous")
    if axis not in (0, 1):
        raise ValueError(f"{name}: axis must be 0 or 1, got {axis}")
    if (table is None) == (cell is None) or (table is None) != (src is None) \
            or (cell is None) != (coef is None):
        raise ValueError(f"{name}: give table and src (dense) or cell and "
                         f"coef (sparse)")
    nseg, width = acc.shape[axis], acc.shape[1 - axis]
    nnz = val.shape[0]
    _check_like(ptr, (nseg + 1,), torch.int32, acc.device, "ptr", name)
    _check_like(val, (nnz,), acc.dtype, acc.device, "val", name)
    if table is not None:
        _check_like(table, (table.shape[0], width), acc.dtype, acc.device,
                    "table", name)
        _check_like(src, (nnz,), torch.int32, acc.device, "src", name)
    else:
        _check_like(cell, (nnz,), torch.int32, acc.device, "cell", name)
        _check_like(coef, (nnz,), acc.dtype, acc.device, "coef", name)
    if max(nseg, width, nnz) > _INT_MAX:
        raise ValueError(f"{name}: sizes ({nseg}, {width}, {nnz}) exceed "
                         f"int32")
    if acc.numel() == 0 or (nnz == 0 and not from_zero):
        return acc
    plan = sparse_fold_plan(nseg, width, axis, acc.dtype)
    strides = (width, 1) if axis == 0 else (1, acc.shape[1])
    lib = _build.library()
    with torch.cuda.device(acc.device):
        rc = lib.rt_sparse_fold(
            acc.data_ptr(), int(acc.dtype == torch.bfloat16), nseg, width,
            nnz, *strides, ptr.data_ptr(), val.data_ptr(),
            *[None if X is None else X.data_ptr()
              for X in (table, src, cell, coef)],
            int(from_zero), SPARSE_FOLD_FORMS[plan["form"]], plan["tc"],
            plan["tj"], plan["smem"], *plan["grid"], _stream(acc.device))
    _launched(rc, name)
    return acc


# ---------------------------------------------------------------------------
# shared memory a block of each kernel takes (the planner's fit)
# ---------------------------------------------------------------------------

# The k depth of the tiled GEMMs' shared-memory stages (kBK of
# csrc/sketch_kernels.cu:134 and csrc/sketch_t_kernels.cu:65); each keeps
# two stages of a kBK x kBM tile of one operand and a kBK x kBN tile of the
# other, in f32 (sketch_kernels.cu:151-152, sketch_t_kernels.cu:87-88).
SKETCH_FWD_BK = 16
SKETCH_T_BK = 8
# The narrow sketch_fwd kernel stages Omega's NP columns in chunks of
# 24576 / NP rows, each column padded by 4 words, in dynamic shared memory
# (Narrow<NP>::kSmem, sketch_kernels.cu:296-302).
_NARROW_CHUNK_WORDS = 24576


def _narrow_smem(np_: int) -> int:
    return 4 * np_ * (_NARROW_CHUNK_WORDS // np_ + 4)


def kernel_smem_bytes() -> dict:
    """Shared memory a block of each of the port's kernels takes,
    ``{kernel: (static bytes, dynamic bytes)}``, from the tile constants
    of ``csrc/`` (the reference's ``vmem_fit_bytes``: the port's tiles are
    fixed, so one number a kernel).  The dynamic bytes are the most a
    launch asks for.  ``kernel_smem_attributes`` reads the same numbers
    on the card."""
    fwd = 2 * SKETCH_FWD_BK * (SKETCH_FWD_TILE + SKETCH_FWD_TILE) * 4
    t = 2 * SKETCH_T_BK * (SKETCH_T_TILE + SKETCH_T_TILE) * 4
    tile = sparse_fold_plan(1, SPARSE_TILE_ROWS, 1, torch.float32)["smem"]
    return {"gen_omega_kernel": (0, 0),
            "omega_slab_draw_kernel": (0, 0),
            "split_reduce_kernel": (0, 0),
            "sketch_fwd_gemm_kernel": (fwd, 0),
            "sketch_fwd_narrow_kernel<4>": (0, _narrow_smem(4)),
            "sketch_fwd_narrow_kernel<8>": (0, _narrow_smem(8)),
            "sketch_fwd_narrow_kernel<16>": (0, _narrow_smem(16)),
            "sketch_t_gemm_kernel": (t, 0),
            "fold_rows_kernel": (0, 0),
            "sparse_fold_rows_kernel": (0, 0),
            "sparse_fold_tile_kernel": (0, tile)}


def sketch_fwd_kernels(n: int) -> tuple:
    """The kernels one ``sketch_fwd`` call of ``n`` output columns
    launches: the Omega slab's draw, the narrow or tiled product, and the
    split reduce (launched only when split)."""
    if sketch_fwd_narrow(n):
        np_ = 4 if n <= 4 else 8 if n <= 8 else 16
        body = f"sketch_fwd_narrow_kernel<{np_}>"
    else:
        body = "sketch_fwd_gemm_kernel"
    return ("omega_slab_draw_kernel", body, "split_reduce_kernel")


SKETCH_T_KERNELS = ("omega_slab_draw_kernel", "sketch_t_gemm_kernel",
                    "split_reduce_kernel")


def kernel_smem_attributes() -> dict:
    """:func:`kernel_smem_bytes` read on the card: each kernel's
    ``cudaFuncGetAttributes`` ``sharedSizeBytes`` and the dynamic bytes
    its launcher asks for, from the built library."""
    lib = _build.library()
    s, d = ctypes.c_int(), ctypes.c_int()
    out = {}

    def read(name, rc):
        if rc != 0:
            msg = lib.rt_error_string(rc).decode()
            raise KernelLaunchError(f"cudaFuncGetAttributes of {name}: "
                                    f"error {rc} ({msg})")
        out[name] = (s.value, d.value)
    fwd = ("gen_omega_kernel", "omega_slab_draw_kernel",
           "split_reduce_kernel", "sketch_fwd_gemm_kernel",
           "sketch_fwd_narrow_kernel<4>", "sketch_fwd_narrow_kernel<8>",
           "sketch_fwd_narrow_kernel<16>")
    for i, name in enumerate(fwd):
        read(name, lib.rt_sketch_fwd_smem(i, ctypes.byref(s),
                                          ctypes.byref(d)))
    read("sketch_t_gemm_kernel",
         lib.rt_sketch_t_smem(ctypes.byref(s), ctypes.byref(d)))
    read("fold_rows_kernel",
         lib.rt_fold_rows_smem(ctypes.byref(s), ctypes.byref(d)))
    for i, name in enumerate(("sparse_fold_rows_kernel",
                              "sparse_fold_tile_kernel")):
        read(name, lib.rt_sparse_fold_smem(i, ctypes.byref(s),
                                           ctypes.byref(d)))
    return out
