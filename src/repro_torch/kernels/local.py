"""The local kernels every one-device path runs through.

  * ``sketch_block``    —  acc? + A · Omega[row0:, col0:col0+cols]
  * ``sketch_t_block``  —  acc? + Omega[row0:, col0:col0+cols]^T · B
  * ``fold_rows_block`` —  y + [0_m; d; 0_m][start : start+m], masked to
                           ``nvalid`` rows, over one lane or many
  * ``gemm_block``      —  acc? + (A · B)·alpha, both operands data (the
                           gradient exchange's factors and error feedback)
  * ``sparse_fold_block`` — COO entries folded into acc's rows or columns
                           in entry order (the sparse row slab's update)

with the Omega (or Psi) tile drawn at GLOBAL Philox coordinates, so the
key pair and the offsets select any shard's block.  ``acc`` fuses the
streaming accumulation ``Y += H·Omega``: the result is written into
``acc`` IN PLACE (the reference rebinds an immutable array instead), or
into a pre-allocated ``out`` view.  The fold, too, updates ``y`` in
place.

Backends (one spelling across the port):

  * ``"cuda"``  — the hand-written kernels (``csrc/sketch_kernels.cu``,
                  ``csrc/sketch_t_kernels.cu``); ``sketch_block`` and
                  ``sketch_t_block`` each draw their Omega slab once a
                  call into a scratch that is released when the call
                  returns.
  * ``"torch"`` — the plain version (``_sketch_block_torch``): Omega
                  materialized by the plain Philox, f32 ``matmul``.  It is
                  the CPU path and the reference the kernel is held to.
  * ``"auto"``  — ``"cuda"`` for CUDA tensors, ``"torch"`` for CPU ones.

A CUDA tensor always goes through the kernel: ``"torch"`` on a CUDA
tensor and ``"cuda"`` on a CPU tensor both raise.  Accumulation is f32 on
both backends with the association ``acc + dot`` and one cast to
``out_dtype`` at the end (the reference's ``backend="jnp"`` body).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from repro_torch.core.sketch import _omega_tile_torch, seed_keys
from repro_torch.core.kinds import validate_kind

from .sketch_matmul import (fold_rows_cuda, gemm_cuda, sketch_fwd_cuda,
                            sketch_t_cuda, sparse_fold_cuda)
from repro_torch.roofline import counts as _counts

BACKENDS = ("torch", "cuda", "auto")


def resolve_backend(backend: str, device) -> str:
    """The concrete backend for tensors on ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (want "
                         f"{'|'.join(BACKENDS)})")
    on_cuda = torch.device(device).type == "cuda"
    if backend == "auto":
        return "cuda" if on_cuda else "torch"
    if backend == "cuda" and not on_cuda:
        raise ValueError(f"backend 'cuda' needs CUDA tensors, got {device}")
    if backend == "torch" and on_cuda:
        raise ValueError("backend 'torch' is the CPU path; CUDA tensors go "
                         "through the CUDA kernels")
    return backend


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _omega_f32(key0, key1, row0, col0, rows: int, cols: int, kind: str,
               salt: int, scale, device) -> torch.Tensor:
    om = _omega_tile_torch(key0, key1, int(row0), int(col0), rows, cols,
                           kind, salt, None, None, device)
    if scale is not None:
        om = om * torch.tensor(scale, dtype=torch.float32, device=device)
    return om


def _sketch_block_torch(A, seed, cols: int, row0=0, col0=0,
                        kind: str = "normal", salt: int = 0, scale=None,
                        acc=None, out_dtype=None) -> torch.Tensor:
    """Plain ``acc? + A @ Omega[row0:, col0:col0+cols]`` (a new tensor)."""
    key0, key1 = seed_keys(seed)
    om = _omega_f32(key0, key1, row0, col0, A.shape[1], cols, kind, salt,
                    scale, A.device)
    out = A.to(torch.float32) @ om
    if acc is not None:
        out = acc.to(torch.float32) + out
    return out.to(out_dtype or A.dtype)


def _sketch_t_block_torch(B, seed, cols: int, row0=0, col0=0,
                          kind: str = "normal", salt: int = 0, scale=None,
                          acc=None, out_dtype=None) -> torch.Tensor:
    """Plain ``acc? + Omega[row0:, col0:col0+cols]^T @ B`` (a new
    tensor)."""
    key0, key1 = seed_keys(seed)
    om = _omega_f32(key0, key1, row0, col0, B.shape[0], cols, kind, salt,
                    scale, B.device)
    out = om.T @ B.to(torch.float32)
    if acc is not None:
        out = acc.to(torch.float32) + out
    return out.to(out_dtype or B.dtype)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _check_acc(acc, shape, out_dtype, what: str = "acc") -> None:
    """The plain path's copy of the launcher's ``acc``/``out`` contract,
    so both paths refuse the same tensors."""
    if acc is not None and (tuple(acc.shape) != tuple(shape)
                            or acc.dtype != out_dtype
                            or not acc.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {out_dtype} tensor "
                         f"of shape {tuple(shape)}, got {tuple(acc.shape)} "
                         f"{acc.dtype}")


def _dispatch(kernel, plain, X, seed, cols, out_shape, row0, col0, kind,
              salt, scale, acc, out_dtype, backend, out=None):
    validate_kind(kind)
    out_dtype = out_dtype or X.dtype
    if resolve_backend(backend, X.device) == "torch":
        _check_acc(acc, out_shape, out_dtype)
        _check_acc(out, out_shape, out_dtype, "out")
        res = plain(X, seed, cols, row0, col0, kind, salt, scale, acc,
                    out_dtype)
        dst = out if out is not None else acc
        return res if dst is None else dst.copy_(res)
    key0, key1 = seed_keys(seed)
    extra = {} if out is None else {"out": out}     # only sketch_fwd has out
    return kernel(X.contiguous(), key0, key1, cols, row0, col0, kind, salt,
                  scale, acc, out_dtype, **extra)


# Each dispatch counts its kernel's work inside ``roofline.counting()``
# (one shape function a kernel, the same on the card and the CPU).

def _fwd_work(A, seed, cols, *, acc=None, out_dtype=None, **_):
    return _counts.sketch_fwd_work(A.shape[0], A.shape[1], cols, A.dtype,
                                   out_dtype or A.dtype, acc is not None)


def _t_work(B, seed, cols, *, acc=None, out_dtype=None, **_):
    return _counts.sketch_t_work(cols, B.shape[0], B.shape[1], B.dtype,
                                 out_dtype or B.dtype, acc is not None)


@_counts.kernel("sketch_fwd", _fwd_work)
def sketch_block(A: torch.Tensor, seed, cols: int, *, row0=0, col0=0,
                 kind: str = "normal", salt: int = 0, scale=None,
                 acc: Optional[torch.Tensor] = None, out_dtype=None,
                 out: Optional[torch.Tensor] = None,
                 backend: str = "auto") -> torch.Tensor:
    """``acc? + A @ Omega[row0:row0+k, col0:col0+cols]`` (k = A.shape[1]).

    The local body of Alg. 1 and of the streaming range update.  ``seed``
    is an int or a (2,) key pair.  The result has ``out_dtype`` (default
    A's dtype); it is written into ``out`` when given, else into ``acc``
    in place when given (both contiguous, of that dtype), and that tensor
    is returned.
    """
    return _dispatch(sketch_fwd_cuda, _sketch_block_torch, A, seed, cols,
                     (A.shape[0], cols), row0, col0, kind, salt, scale, acc,
                     out_dtype, backend, out=out)


@_counts.kernel("sketch_t", _t_work)
def sketch_t_block(B: torch.Tensor, seed, cols: int, *, row0=0, col0=0,
                   kind: str = "normal", salt: int = 0, scale=None,
                   acc: Optional[torch.Tensor] = None, out_dtype=None,
                   backend: str = "auto") -> torch.Tensor:
    """``acc? + Omega[row0:row0+n, col0:col0+cols]^T @ B`` (n = B.shape[0]).

    The Nystrom second stage (C = Omega^T·B) and the streaming co-range
    update (W += Psi·H under Psi's salt).  Same contract as
    :func:`sketch_block`, without ``out``: the result goes into ``acc`` in
    place when given, else into a new tensor.
    """
    return _dispatch(sketch_t_cuda, _sketch_t_block_torch, B, seed, cols,
                     (cols, B.shape[1]), row0, col0, kind, salt, scale, acc,
                     out_dtype, backend)


def _fold_rows_torch(y: torch.Tensor, d: torch.Tensor, start,
                     nvalid=None) -> torch.Tensor:
    """Plain ``y + [0_m; d; 0_m][start : start + m]`` (a new tensor), the
    reference's ``_fold_rows_jnp`` operation by operation: the zero frame,
    the clamped slice (``jax.lax.dynamic_slice`` clamps ``start`` into
    ``[0, m + k]``), the add, and with ``nvalid`` the ``where`` on the
    UNCLAMPED start, so rows not fed by the first ``nvalid`` rows of ``d``
    keep y's exact bits.  The sum is rounded once to y's dtype.

    With a leading lane axis (``y`` (n, m, c), ``d`` (n, k, c), ``start``
    and ``nvalid`` one integer per lane) it folds each lane, as the
    reference's ``jax.vmap`` does.
    """
    if y.dim() == 3:
        n = y.shape[0]
        starts = _per_lane(start, n)
        nvalids = None if nvalid is None else _per_lane(nvalid, n)
        return torch.stack([
            _fold_rows_torch(y[i], d[i], starts[i],
                             None if nvalids is None else nvalids[i])
            for i in range(n)])
    m, c = y.shape
    k = d.shape[0]
    start = int(start)
    pad = torch.zeros((m, c), dtype=d.dtype, device=d.device)
    frame = torch.cat([pad, d, pad])
    win = frame.narrow(0, min(max(start, 0), m + k), m)
    out = (y + win).to(y.dtype)
    if nvalid is None:
        return out
    idx = start + torch.arange(m, device=y.device)
    live = (idx >= m) & (idx < m + int(nvalid))
    return torch.where(live[:, None], out, y)


def _per_lane(v, n: int) -> list:
    scalar = isinstance(v, int) or (not isinstance(v, (list, tuple))
                                    and getattr(v, "ndim", 1) == 0)
    vals = [int(v)] * n if scalar else list(map(int, v))
    if len(vals) != n:
        raise ValueError(f"need one value per lane ({n}), got {len(vals)}")
    return vals


def _fold_work(y, d, start, nvalid=None):
    lanes = [y] if isinstance(y, torch.Tensor) else list(y)
    if not lanes:
        return None
    n = len(lanes)
    return _counts.fold_rows_work(
        lanes[0].shape[0], d.shape[-2], d.shape[-1], lanes[0].dtype, d.dtype,
        _per_lane(start, n), None if nvalid is None else _per_lane(nvalid, n))


@_counts.kernel("fold_rows", _fold_work)
def fold_rows_block(y: Union[torch.Tensor, Sequence[torch.Tensor]],
                    d: torch.Tensor, start, nvalid=None):
    """``y <- y + [0_m; d; 0_m][start : start + m]`` IN PLACE — the
    row-slab fold of the streaming update (the reference's
    ``fold_rows_block``, which returns a new array).

    ``y`` is one (m, c) tensor with ``d`` (k, c) and integer ``start`` /
    ``nvalid``, or a sequence of lanes' (m, c) tensors (each its own
    allocation) with ``d`` (lanes, k, c) and one integer per lane.  With
    ``nvalid`` only y rows fed by the first ``nvalid`` rows of ``d``
    change; every other row keeps its exact bits (not even +0.0 is added,
    so a resident -0.0 survives and NaN pad rows of ``d`` are never
    read).  Without it every row is rewritten as ``y + win``.  When ``d``
    is on the card all lanes go through ONE launch of the K4 kernel (one
    per ``FOLD_LANE_CAPACITY`` = 240 lanes); when it is on the CPU each
    lane runs :func:`_fold_rows_torch`.  Returns ``y``.
    """
    lanes = [y] if isinstance(y, torch.Tensor) else list(y)
    if isinstance(y, torch.Tensor):
        d = d.unsqueeze(0)
        start = [start]
        nvalid = None if nvalid is None else [nvalid]
    if not lanes:
        return y
    starts = _per_lane(start, len(lanes))
    nvalids = None if nvalid is None else _per_lane(nvalid, len(lanes))
    if d.is_cuda:
        fold_rows_cuda(lanes, d, starts, nvalids)
        return y
    for i, yi in enumerate(lanes):
        yi.copy_(_fold_rows_torch(yi, d[i], starts[i],
                                  None if nvalids is None else nvalids[i]))
    return y


def _gemm_block_torch(A: torch.Tensor, B: torch.Tensor, alpha: float = 1.0,
                      acc: Optional[torch.Tensor] = None,
                      out_dtype=None) -> torch.Tensor:
    """Plain ``acc? + (A @ B)·alpha`` (a new tensor): the reference's
    ``_gemm_jnp`` operation by operation — an f32 product, scaled by alpha
    unless it is 1, then the accumulator added, then one cast."""
    out = A.to(torch.float32) @ B.to(torch.float32)
    if alpha != 1.0:
        out = out * torch.tensor(alpha, dtype=torch.float32, device=A.device)
    if acc is not None:
        out = acc.to(torch.float32) + out
    return out.to(out_dtype or A.dtype)


def _gemm_work(A, B, *, acc=None, out_dtype=None, **_):
    return _counts.gemm_work(A.shape[0], B.shape[1], A.shape[1], A.dtype,
                             B.dtype, out_dtype or A.dtype, acc is not None)


@_counts.kernel("gemm", _gemm_work)
def gemm_block(A: torch.Tensor, B: torch.Tensor, *, alpha: float = 1.0,
               acc: Optional[torch.Tensor] = None, out_dtype=None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc? + alpha · (A @ B)`` — the dense GEMM of the gradient exchange
    (the reference's ``gemm_block``): ``P̂ᵀ·M``, ``P̂·Qᵀ`` and the error
    feedback ``E' = gemm_block(P̂, Q_locᵀ, acc=M, alpha=-1)``.

    Summed in f32 with the association ``acc + (dot · alpha)`` and cast
    once to ``out_dtype`` (default A's dtype).  The result goes into ``out``
    when given, else into ``acc`` IN PLACE when given (the reference
    aliases the accumulator to the output), else into a new tensor.  On the
    card the K5 kernel runs (``A`` may be a transposed view, ``B``
    contiguous, both float32); on the CPU the plain version.
    """
    out_dtype = out_dtype or A.dtype
    alpha = float(alpha)
    if A.is_cuda:
        return gemm_cuda(A, B.contiguous(), alpha, acc, out_dtype, out)
    shape = (A.shape[0], B.shape[1])
    _check_acc(acc, shape, out_dtype)
    _check_acc(out, shape, out_dtype, "out")
    res = _gemm_block_torch(A, B, alpha, acc, out_dtype)
    dst = out if out is not None else acc
    return res if dst is None else dst.copy_(res)


def sparse_csr(dest: torch.Tensor, nseg: int):
    """``(order, ptr)`` of COO entries over ``nseg`` destinations: ``order``
    sorts the entries by destination STABLY (entry order survives within a
    destination), ``ptr`` (int32, ``nseg + 1``) delimits each destination's
    run of ``dest[order]``."""
    sorted_dest, order = torch.sort(dest.to(torch.int64), stable=True)
    ptr = torch.searchsorted(sorted_dest, torch.arange(
        nseg + 1, dtype=torch.int64, device=dest.device))
    return order, ptr.to(torch.int32)


def _sparse_fold_torch(acc: torch.Tensor, dest: torch.Tensor,
                       val: torch.Tensor, table=None, src=None, cell=None,
                       coef=None, axis: int = 0,
                       from_zero: bool = False) -> torch.Tensor:
    """Plain :func:`sparse_fold_block` (a new tensor), in waves: entries
    sorted stably by destination, wave j adds the j-th entry of every
    destination (one gather, multiply and add, written back by plain
    indexing; no index repeats within a wave), so each destination takes
    its entries in entry order and every product and add is rounded to
    acc's type, as the reference's sequential scatter does."""
    work = torch.zeros_like(acc) if from_zero else acc.clone()
    view = work if axis == 0 else work.T
    dest = dest.to(torch.int64)
    order, ptr = sparse_csr(dest, acc.shape[axis])
    rank = (torch.arange(order.numel(), device=acc.device)
            - ptr.to(torch.int64)[dest[order]])
    waves = int(rank.max()) + 1 if rank.numel() else 0
    for j in range(waves):
        e = order[rank == j]
        d = dest[e]
        if table is not None:
            view[d] = view[d] + val[e, None] * table[src[e].to(torch.int64)]
        else:
            c = cell[e].to(torch.int64)
            view[d, c] = view[d, c] + val[e] * coef[e]
    return acc + work if from_zero else work


def sparse_fold_block(acc: torch.Tensor, dest: torch.Tensor,
                      val: torch.Tensor, *,
                      table: Optional[torch.Tensor] = None,
                      src: Optional[torch.Tensor] = None,
                      cell: Optional[torch.Tensor] = None,
                      coef: Optional[torch.Tensor] = None, axis: int = 0,
                      from_zero: bool = False) -> torch.Tensor:
    """Fold COO entries into the rows (``axis=0``) or columns (``axis=1``)
    of ``acc`` IN PLACE — the scatter of the sparse row-slab update
    (``stream/state.py`` :func:`sparse_rowblock_update`).

    Entry e goes to segment ``dest[e]`` of acc and adds, in entry order,
    ``val[e]·table[src[e], :]`` along it (the dense kinds: a row of the
    Omega or Psi tile) or ``val[e]·coef[e]`` at position ``cell[e]`` of it
    (the sparse kinds: one cell).  Every product and every add is rounded
    to acc's type, which ``val``, ``table`` and ``coef`` share.  With
    ``from_zero`` the sums start at 0 and EVERY segment becomes ``acc +
    sum``, rounded once (the range update's ``Yk + dY``); else they
    accumulate straight into acc and segments with no entries keep their
    bits (the co-range update of W).  Indices must lie in range.

    On the card: a stable sort by destination (:func:`sparse_csr`), then
    one launch of the S1 kernel; on the CPU the plain wave form
    :func:`_sparse_fold_torch`.  Returns ``acc``.
    """
    if (table is None) == (cell is None) or (table is None) != (src is None) \
            or (cell is None) != (coef is None):
        raise ValueError("sparse_fold_block: give table and src (dense) or "
                         "cell and coef (sparse)")
    for what, X in (("val", val), ("table", table), ("coef", coef)):
        if X is not None and X.dtype != acc.dtype:
            raise ValueError(f"sparse_fold_block: {what} is {X.dtype}, acc "
                             f"{acc.dtype}: cast the entries first")
    if not acc.is_cuda:
        return _sparse_fold_plain(acc, dest, val, table, src, cell, coef,
                                  axis, from_zero)
    ptr, entries = sparse_fold_operands(dest, acc.shape[axis], val, src,
                                        cell, coef)
    return _sparse_fold_launch(acc, ptr, table=table, axis=axis,
                               from_zero=from_zero, **entries)


# The two bodies of sparse_fold_block, each counted as one S1 call; the
# card's CSR build between them is torch ops, counted as such.

def _s1_work(acc, index, val, table=None, src=None, cell=None, coef=None,
             axis=0, from_zero=False):
    return _counts.sparse_fold_work(
        acc.shape[axis], acc.shape[1 - axis], val.shape[0], acc.dtype,
        None if table is None else table.shape[0], from_zero)


@_counts.kernel("sparse_fold", _s1_work)
def _sparse_fold_plain(acc, dest, val, table, src, cell, coef, axis,
                       from_zero):
    return acc.copy_(_sparse_fold_torch(acc, dest, val, table, src, cell,
                                        coef, axis, from_zero))


@_counts.kernel("sparse_fold", _s1_work)
def _sparse_fold_launch(acc, ptr, **kw):
    return sparse_fold_cuda(acc, ptr, **kw)


def sparse_fold_operands(dest: torch.Tensor, nseg: int, val: torch.Tensor,
                         src=None, cell=None, coef=None):
    """What the card path hands S1: ``ptr`` over ``nseg`` destinations and
    the entry arrays (``val`` and ``src`` or ``cell`` / ``coef``) gathered
    into CSR order, indices as int32 (:func:`sparse_csr`)."""
    order, ptr = sparse_csr(dest, nseg)

    def csr(X, dtype=None):
        return None if X is None else X[order].to(dtype or X.dtype)
    return ptr, {"val": csr(val), "src": csr(src, torch.int32),
                 "cell": csr(cell, torch.int32), "coef": csr(coef)}
