"""One-pass streaming sketch state on one device (Tropp et al. 2017).

The sketches are linear in A, so for any additive update

    A  <-  A + H      =>      Y  <-  Y + H·Omega ,   W  <-  W + Psi·H

with Y = A·Omega (n1 x r) the range sketch and W = Psi·A (l x n2) the
co-range sketch.  Omega and Psi are regenerated from the seed under two
salts, so only the O((n1 + n2)·r) sketch state is stored.

For the dense kinds every dense-slab update runs through the fused kernels
of ``kernels/local.py`` (on the card, the CUDA kernels; Omega and Psi never
exist in device memory).  The sparse kinds have no GEMM kernel: they
materialize their tile and multiply, on any device, as the reference does.

A slab may also arrive as COO entries (:class:`SparseRows`, ``2·nnz``
words instead of ``k·n2``): :func:`sparse_rowblock_update` folds them
without densifying, through ``kernels.local.sparse_fold_block`` (on the
card the S1 kernel, one launch a sketch), giving bitwise the reference's
sequential scatter for every kind, in float32 and bfloat16.

Unlike the reference, whose updates rebind immutable arrays, the updates
here write into ``Y`` and ``W`` IN PLACE.

Each Y row is produced by one full-contraction kernel call whose per-
element summation order does not depend on the slab height, so a
row-partitioned stream reproduces the one-shot sketch of the same kernel.

The many-streams service (``service.py``) runs two plain functions of
this module: :func:`rowblock_update`, one stream's row-slab update (what
``StreamingSketch.update_rows`` runs), and :func:`local_rowblock_ragged`,
the lane-batched update of many streams whose slabs were staged into one
padded buffer: per-lane ``dY`` products, ONE masked fold of every lane's
``dY`` into its own ``Y`` (the K4 kernel on the card), per-lane ``W``
updates.  Lane i of it is bitwise ``rowblock_update`` of stream i alone,
for float32 and bfloat16 streams.  Its sparse counterpart
:func:`local_sparse_batch` runs :func:`sparse_rowblock_update` lane by
lane.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.kinds import SPARSE_KINDS, validate_kind
from repro_torch.core.sketch import (omega_tile, resolve_device, seed_keys,
                                     sparse_omega_rows)
from repro_torch.kernels.local import (fold_rows_block, resolve_backend,
                                       sketch_block, sketch_t_block,
                                       sparse_fold_block)

OMEGA_SALT = 0   # salt stream for Omega (range sketch)
PSI_SALT = 1     # salt stream for Psi (co-range sketch); must differ

_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.bfloat16: "bfloat16"}
_NAME_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Shape/seed contract of one stream (fields as in the reference, so
    its ``to_json_dict`` round-trips here).

    n1, n2 : global shape of the streamed matrix A
    r      : range-sketch size (columns of Omega)
    l      : co-range-sketch size (rows of Psi); default min(2r+1, n1)
    seed   : Philox seed; Omega and Psi differ by salt
    kind   : "normal" | "uniform" | "rademacher" | "countsketch" |
             "rowsample"
    corange: track W = Psi·A (needed for the one-pass reconstruction)
    """
    n1: int
    n2: int
    r: int
    l: Optional[int] = None
    seed: int = 0
    kind: str = "normal"
    dtype: Any = torch.float32
    corange: bool = True
    omega_salt: int = OMEGA_SALT
    psi_salt: int = PSI_SALT

    @property
    def sketch_l(self) -> int:
        return self.l if self.l is not None else min(2 * self.r + 1, self.n1)

    def validate(self):
        validate_kind(self.kind)
        if self.r <= 0 or self.n1 <= 0 or self.n2 <= 0:
            raise ValueError(f"bad stream shape {self}")
        if self.omega_salt == self.psi_salt and self.corange:
            raise ValueError("omega_salt and psi_salt must differ")
        if self.dtype not in _DTYPE_NAMES:
            raise ValueError(f"unsupported stream dtype {self.dtype}")

    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["dtype"] = _DTYPE_NAMES[self.dtype]
        return d

    @classmethod
    def from_json_dict(cls, d: dict) -> "StreamConfig":
        d = dict(d)
        d["dtype"] = _NAME_DTYPES[str(d["dtype"])]
        return cls(**d)


def omega_matrix(cfg: StreamConfig, seed=None, device=None) -> torch.Tensor:
    """The full (n2, r) Omega of a stream (``device=None``: the card)."""
    return omega_tile(cfg.seed if seed is None else seed, 0, 0, cfg.n2,
                      cfg.r, cfg.kind, cfg.dtype, salt=cfg.omega_salt,
                      device=device)


def psi_matrix(cfg: StreamConfig, seed=None, device=None) -> torch.Tensor:
    """The full (l, n1) Psi, as the transpose of an (n1, l) tile so that
    its column slices share global row coordinates with row updates."""
    return omega_tile(cfg.seed if seed is None else seed, 0, 0, cfg.n1,
                      cfg.sketch_l, cfg.kind, cfg.dtype, salt=cfg.psi_salt,
                      n_total=cfg.n1, device=device).T


def psi_cols(cfg: StreamConfig, row0: int, rows: int, seed=None,
             device=None) -> torch.Tensor:
    """Psi[:, row0:row0+rows] as an (rows, l) tile (pre-transpose)."""
    return omega_tile(cfg.seed if seed is None else seed, row0, 0, rows,
                      cfg.sketch_l, cfg.kind, cfg.dtype, salt=cfg.psi_salt,
                      n_total=cfg.n1, device=device)


def validate_row_block(cfg: StreamConfig, row0: int,
                       shape: Tuple[int, int]) -> None:
    k, n2 = shape
    if n2 != cfg.n2 or row0 < 0 or row0 + k > cfg.n1:
        raise ValueError(f"row block ({row0}, {tuple(shape)}) outside "
                         f"({cfg.n1}, {cfg.n2})")


def _host(x) -> np.ndarray:
    """A payload array (numpy or tensor) as numpy, for the checks."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


@dataclasses.dataclass(frozen=True)
class SparseRows:
    """A sparse row slab in COO form: ``A[row0 + row[e], col[e]] += val[e]``.

    ``shape = (k, n2)`` is the DENSE slab shape the entries live in; the
    wire format is (indices, values) — ``2·nnz`` words instead of the dense
    slab's ``k·n2`` (``plan.model.sparse_payload_words``).  The arrays may
    be numpy arrays or tensors (on any device); entries may come in any
    order and repeat a coordinate.
    """
    row: Any                   # (nnz,) integer, local row within the slab
    col: Any                   # (nnz,) integer, global column in [0, n2)
    val: Any                   # (nnz,) values
    shape: Tuple[int, int]     # (k, n2)

    @property
    def nnz(self) -> int:
        return int(_shape(self.row)[0])

    @classmethod
    def from_dense(cls, H) -> "SparseRows":
        """COO of a dense slab (entry order: row-major, as np.nonzero)."""
        H = _host(H)
        r, c = np.nonzero(H)
        return cls(row=np.asarray(r, np.int32), col=np.asarray(c, np.int32),
                   val=H[r, c], shape=tuple(H.shape))

    def to_dense(self, dtype=None) -> np.ndarray:
        """The dense slab as numpy (repeated coordinates summed by
        ``np.add.at``)."""
        val = _host(self.val)
        out = np.zeros(self.shape, dtype or val.dtype)
        np.add.at(out, (_host(self.row), _host(self.col)), val)
        return out

    def validate(self, cfg: StreamConfig, row0: int) -> None:
        validate_row_block(cfg, row0, self.shape)
        k, n2 = self.shape
        row, col = _host(self.row), _host(self.col)
        if row.shape != col.shape or row.shape != _shape(self.val):
            raise ValueError(f"ragged COO arrays: {row.shape} / "
                             f"{col.shape} / {_shape(self.val)}")
        if row.size and (row.min() < 0 or row.max() >= k
                         or col.min() < 0 or col.max() >= n2):
            raise ValueError(f"COO indices outside slab shape {self.shape}")

    def padded(self, nnz_b: int):
        """(row, col, val) as numpy, padded to ``nnz_b`` entries with pads
        ``row == k`` / ``col == n2`` / ``val == 0`` (the reference's bucket
        layout; the port's updates take the unpadded payload)."""
        k, n2 = self.shape
        nnz = self.nnz
        if nnz > nnz_b:
            raise ValueError(f"nnz={nnz} exceeds bucket {nnz_b}")
        pad = nnz_b - nnz
        val = _host(self.val)
        row = np.concatenate([np.asarray(_host(self.row), np.int32),
                              np.full(pad, k, np.int32)])
        col = np.concatenate([np.asarray(_host(self.col), np.int32),
                              np.full(pad, n2, np.int32)])
        return row, col, np.concatenate([val, np.zeros(pad, val.dtype)])


def nystrom_local(Y: torch.Tensor, cfg: StreamConfig):
    """(B, C) of a symmetric stream: C = Omega^T·Y from the sketch alone."""
    if cfg.kind in SPARSE_KINDS:
        om = omega_tile(cfg.seed, 0, 0, cfg.n2, cfg.r, cfg.kind, Y.dtype,
                        salt=cfg.omega_salt, device=Y.device)
        return Y, om.T @ Y
    return Y, sketch_t_block(Y, cfg.seed, cfg.r, kind=cfg.kind,
                             salt=cfg.omega_salt)


def _local_sig(cfg: StreamConfig) -> Tuple:
    """What lanes of one batched update must share (NOT the seed): the
    shapes, kind, dtype and salts."""
    return (cfg.n1, cfg.n2, cfg.r, cfg.sketch_l if cfg.corange else None,
            cfg.kind, _DTYPE_NAMES[cfg.dtype], cfg.corange, cfg.omega_salt,
            cfg.psi_salt)


def pow2_bucket(k: int) -> int:
    """Smallest power of two >= k — the default ragged bucket snap."""
    if k <= 1:
        return 1
    return 1 << (k - 1).bit_length()


def snap_bucket(k: int, edges=None) -> int:
    """Bucket height for a k-row lane: the smallest edge >= k when
    ``edges`` (ascending bucket tops) is given — a lane taller than every
    edge falls back to the pow2 snap — else the pow2 snap.  Height-1
    lanes are never padded into a taller bucket.  (The reference's rule,
    kept so that both systems bucket, and count pad rows, alike.)"""
    if k <= 1:
        return 1
    if edges is None:
        return pow2_bucket(k)
    for e in edges:
        if e >= k:
            return int(e)
    return pow2_bucket(k)


def _slab_W(cfg: StreamConfig, keys, W: torch.Tensor, row0: int,
            H: torch.Tensor, backend: str = "auto") -> None:
    """W += Psi[:, row0:row0+k]·H in place."""
    if cfg.kind in SPARSE_KINDS:
        W += psi_cols(cfg, row0, H.shape[0], device=H.device).T @ H
    else:
        sketch_t_block(H, keys, cfg.sketch_l, row0=row0, acc=W,
                       kind=cfg.kind, salt=cfg.psi_salt, backend=backend)


def rowblock_update(cfg: StreamConfig, keys, Y: torch.Tensor,
                    W: Optional[torch.Tensor], row0: int, H: torch.Tensor,
                    backend: str = "auto") -> None:
    """One stream's row-slab update, in place: Y[row0:row0+k] += H·Omega
    (rounded once: ``acc + dot``) and W += Psi[:, row0:row0+k]·H.  ``H``
    is a (k, n2) tensor of the stream's dtype on Y's device; the caller
    has validated the block."""
    k = H.shape[0]
    Yk = Y[row0:row0 + k]                    # a contiguous row view
    if cfg.kind in SPARSE_KINDS:
        Yk += H @ omega_matrix(cfg, device=H.device)
    else:
        sketch_block(H, keys, cfg.r, acc=Yk, kind=cfg.kind,
                     salt=cfg.omega_salt, backend=backend)
    if W is not None:
        _slab_W(cfg, keys, W, row0, H, backend)


def local_rowblock_ragged(lanes: Sequence[Tuple], Hb: torch.Tensor) -> None:
    """The lane-batched row-slab update (ragged or same-height), in place.

    ``lanes[i] = (cfg, keys, Y, W, row0, k)`` — every lane shares one
    :func:`_local_sig` and owns its ``Y`` and ``W``; ``Hb`` is the
    (lanes, kb, n2) staged buffer on Y's device, lane i's slab in
    ``Hb[i, :k]`` (rows ``k:kb`` are padding and are never read).

      1. per lane, ``dY_i = H_i·Omega_i`` into an f32 ``dYb[i, :k]``
         (``sketch_fwd``, written into the view);
      2. ONE masked fold of every ``dYb[i, :k]`` into its own ``Y`` at
         ``row0`` (``fold_rows_block`` with ``start = n1 - row0``,
         ``nvalid = k``: the K4 kernel on the card), adding in f32 and
         rounding once into Y's dtype;
      3. per lane, ``W_i += Psi_i·H_i`` (``sketch_t`` with ``acc=W_i``).

    Step 2 is the solo update's ``acc + dot`` with one rounding, so lane i
    is bitwise :func:`rowblock_update` of stream i alone, for float32 and
    bfloat16 streams.  (The sparse kinds form ``dY`` by a product with
    their materialized Omega, as their solo update does.)
    """
    cfg0 = lanes[0][0]
    n, kb, _ = Hb.shape
    dYb = torch.empty((n, kb, cfg0.r), dtype=torch.float32, device=Hb.device)
    for i, (cfg, keys, _, _, _, k) in enumerate(lanes):
        if cfg.kind in SPARSE_KINDS:
            dYb[i, :k].copy_(Hb[i, :k] @ omega_matrix(cfg, device=Hb.device))
        else:
            sketch_block(Hb[i, :k], keys, cfg.r, kind=cfg.kind,
                         salt=cfg.omega_salt, out_dtype=torch.float32,
                         out=dYb[i, :k])
    fold_rows_block([ln[2] for ln in lanes], dYb,
                    start=[cfg0.n1 - ln[4] for ln in lanes],
                    nvalid=[ln[5] for ln in lanes])
    for i, (cfg, keys, _, W, row0, k) in enumerate(lanes):
        if W is not None:
            _slab_W(cfg, keys, W, row0, Hb[i, :k])


def _entries(sp: SparseRows, device, dtype):
    """The payload on ``device``: int64 indices and the values cast to the
    stream's dtype (the reference's first rounding)."""
    def t(x):
        return x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
    return (t(sp.row).to(device=device, dtype=torch.int64),
            t(sp.col).to(device=device, dtype=torch.int64),
            t(sp.val).to(device=device, dtype=dtype))


def sparse_update_folds(cfg: StreamConfig, keys, Y: torch.Tensor,
                        W: Optional[torch.Tensor], row0: int,
                        sp: SparseRows) -> list:
    """The folds of one stream's COO row-slab update, ``[(acc, dest, val,
    kw)]`` for Y and then W: each is ``sparse_fold_block(acc, dest, val,
    **kw)`` (see :func:`sparse_rowblock_update`), with the payload on Y's
    device, the values in the stream's dtype and the draws made."""
    k = sp.shape[0]
    row, col, val = _entries(sp, Y.device, cfg.dtype)
    Yk = Y[row0:row0 + k]                    # a contiguous row view
    sparse = cfg.kind in SPARSE_KINDS
    if sparse:
        b, v = sparse_omega_rows(keys, col, cfg.r, cfg.kind, cfg.dtype,
                                 salt=cfg.omega_salt, n_total=cfg.n2)
        kw = dict(cell=b, coef=v)
    else:
        kw = dict(table=omega_tile(keys, 0, 0, cfg.n2, cfg.r, cfg.kind,
                                   cfg.dtype, salt=cfg.omega_salt,
                                   device=Y.device), src=col)
    folds = [(Yk, row, val, dict(kw, from_zero=True))]
    if W is None:
        return folds
    if sparse:
        pb, pv = sparse_omega_rows(keys, row0 + row, cfg.sketch_l, cfg.kind,
                                   cfg.dtype, salt=cfg.psi_salt,
                                   n_total=cfg.n1)
        kw = dict(cell=pb, coef=pv)
    else:
        kw = dict(table=omega_tile(keys, row0, 0, k, cfg.sketch_l, cfg.kind,
                                   cfg.dtype, salt=cfg.psi_salt,
                                   n_total=cfg.n1, device=W.device), src=row)
    return folds + [(W, col, val, dict(kw, axis=1))]


def sparse_rowblock_update(cfg: StreamConfig, keys, Y: torch.Tensor,
                           W: Optional[torch.Tensor], row0: int,
                           sp: SparseRows) -> None:
    """One stream's COO row-slab update, in place: the reference's
    ``_local_sparse_update`` with the same rounding points.

      * Y: ``dY`` starts at zero; entry e adds ``val[e]·Omega[col[e], :]``
        to row ``row[e]`` (the dense kinds, Omega drawn in the stream's
        dtype) or ``val[e]·v[e]`` to the one cell ``(row[e], b[e])`` (the
        sparse kinds, ``(b, v)`` drawn at ``col``); then EVERY row of the
        slab becomes ``Yk + dY``.
      * W accumulates straight into itself: entry e adds
        ``Psi[:, row0 + row[e]]·val[e]`` to column ``col[e]`` (Psi's rows
        drawn as a (k, l) tile) or ``pv[e]·val[e]`` to the cell
        ``(pb[e], col[e])`` (drawn at ``row0 + row``); columns with no
        entry are not touched.

    Each destination takes its entries in entry order, every product and
    add rounded to the stream's dtype: on the card one S1 launch a sketch
    (the dense kinds' tiles from the gen-Omega kernel), on the CPU the
    plain wave form.  No pads, no bucket.  The caller has validated ``sp``
    (``SparseRows.validate``).
    """
    for acc, dest, val, kw in sparse_update_folds(cfg, keys, Y, W, row0, sp):
        sparse_fold_block(acc, dest, val, **kw)


def local_sparse_batch(lanes: Sequence[Tuple],
                       payloads: Sequence[SparseRows]) -> None:
    """The lane-batched COO update, in place: ``lanes[i] = (cfg, keys, Y,
    W, row0)`` takes ``payloads[i]``.  Every lane shares one
    :func:`_local_sig` and one slab height (the service checks both) and
    owns its ``Y`` and ``W``; nothing is summed across lanes, so lane i is
    bitwise :func:`sparse_rowblock_update` of stream i alone.  It runs
    that update lane by lane: on the card two S1 launches a lane (one
    without W)."""
    for (cfg, keys, Y, W, row0), sp in zip(lanes, payloads, strict=True):
        sparse_rowblock_update(cfg, keys, Y, W, row0, sp)


class StreamingSketch:
    """One-device streaming accumulator for (Y, W).

    ``device=None`` means the card (and raises without one); pass
    ``device="cpu"`` for the plain torch path.  ``backend`` is
    ``"torch" | "cuda" | "auto"`` as in ``kernels/local.py`` and must
    agree with the device.
    """

    def __init__(self, cfg: StreamConfig, device=None,
                 backend: str = "auto"):
        cfg.validate()
        self.device = resolve_device(device)
        self.backend = resolve_backend(backend, self.device)
        self.cfg = cfg
        self.Y = torch.zeros((cfg.n1, cfg.r), dtype=cfg.dtype,
                             device=self.device)
        self.W = (torch.zeros((cfg.sketch_l, cfg.n2), dtype=cfg.dtype,
                              device=self.device)
                  if cfg.corange else None)
        self.keys = seed_keys(cfg.seed)
        self.num_updates = 0

    def _as_slab(self, H) -> torch.Tensor:
        return torch.as_tensor(H).to(device=self.device,
                                     dtype=self.cfg.dtype)

    def _kw(self, salt: int) -> dict:
        return dict(kind=self.cfg.kind, salt=salt, backend=self.backend)

    # -- updates -----------------------------------------------------------

    def update_rows(self, row0: int, H):
        """Rows [row0, row0+k) arrive (additively): Y[row0:row0+k] += H·Omega
        and W += Psi[:, row0:row0+k]·H, both in place."""
        validate_row_block(self.cfg, row0, tuple(H.shape))
        rowblock_update(self.cfg, self.keys, self.Y, self.W, row0,
                        self._as_slab(H), self.backend)
        self.num_updates += 1
        return self

    def update_rows_sparse(self, row0: int, sp: SparseRows):
        """Rows [row0, row0+k) arrive as a COO slab (additively): the
        numbers :meth:`update_rows` would fold for the densified slab, up
        to the order of summation, with the reference's bits
        (:func:`sparse_rowblock_update`); the slab is never densified."""
        sp.validate(self.cfg, row0)
        sparse_rowblock_update(self.cfg, self.keys, self.Y, self.W, row0, sp)
        self.num_updates += 1
        return self

    def update_cols(self, col0: int, H):
        """Columns [col0, col0+k) arrive (additively)."""
        cfg = self.cfg
        n1, k = H.shape
        if n1 != cfg.n1 or col0 < 0 or col0 + k > cfg.n2:
            raise ValueError(f"col block ({col0}, {tuple(H.shape)}) outside "
                             f"({cfg.n1}, {cfg.n2})")
        H = self._as_slab(H)
        if cfg.kind in SPARSE_KINDS:
            self.Y += H @ omega_tile(cfg.seed, col0, 0, k, cfg.r, cfg.kind,
                                     cfg.dtype, salt=cfg.omega_salt,
                                     n_total=cfg.n2, device=self.device)
            if self.W is not None:
                self.W[:, col0:col0 + k] += (
                    psi_matrix(cfg, device=self.device) @ H)
        else:
            sketch_block(H, self.keys, cfg.r, row0=col0, acc=self.Y,
                         **self._kw(cfg.omega_salt))
            if self.W is not None:
                self.W[:, col0:col0 + k] += sketch_t_block(
                    H, self.keys, cfg.sketch_l, **self._kw(cfg.psi_salt))
        self.num_updates += 1
        return self

    def update(self, H):
        """General additive update A <- A + H with H of full shape."""
        if tuple(H.shape) != (self.cfg.n1, self.cfg.n2):
            raise ValueError(f"update shape {tuple(H.shape)} != "
                             f"({self.cfg.n1}, {self.cfg.n2})")
        return self.update_rows(0, H)

    # -- finalization ------------------------------------------------------

    @property
    def sketch(self) -> torch.Tensor:
        """The accumulated range sketch Y = A·Omega."""
        return self.Y

    @property
    def corange_sketch(self) -> Optional[torch.Tensor]:
        return self.W

    def nystrom(self):
        """(B, C) Nystrom pair of a symmetric stream, C = Omega^T·Y."""
        if self.cfg.n1 != self.cfg.n2:
            raise ValueError("Nystrom needs a square (symmetric) stream")
        return nystrom_local(self.Y, self.cfg)

    def reconstruct(self, rank: Optional[int] = None, rcond=None):
        """One-pass fixed-rank approximation A ~= Q·(Psi Q)†·W."""
        from .reconstruct import one_pass_reconstruct
        if self.W is None:
            raise ValueError("reconstruction needs corange=True")
        return one_pass_reconstruct(self.Y, self.W, self.cfg, rank=rank,
                                    rcond=rcond)

    # -- checkpointing -----------------------------------------------------

    def save(self, directory: str, step: Optional[int] = None,
             keep: int = 3) -> str:
        """Checkpoint (Y, W) with (config, num_updates) in the manifest's
        ``extra`` (``checkpoint.ckpt``, atomic; layout ``"local"``).  The
        sketch state plus the seed is the whole stream, so a restored
        stream continues bitwise.  Returns the checkpoint's path."""
        from repro_torch.checkpoint import ckpt
        step = self.num_updates if step is None else step
        tree = {"Y": self.Y}
        if self.W is not None:
            tree["W"] = self.W
        extra = {"config": self.cfg.to_json_dict(),
                 "num_updates": self.num_updates,
                 "backend": self.backend, "layout": "local"}
        return ckpt.save(directory, step, tree, extra=extra, keep=keep)

    @classmethod
    def restore(cls, directory: str, step: Optional[int] = None,
                device=None) -> "StreamingSketch":
        """Rebuild a stream (config and state) from a checkpoint onto
        ``device`` (``None``: the card).  The saved ``backend`` is kept in
        the manifest only: the kernels follow the device."""
        from repro_torch.checkpoint import ckpt
        tree, _, extra = ckpt.restore_tree(directory, step)
        st = cls(StreamConfig.from_json_dict(extra["config"]), device=device)
        st.Y.copy_(tree["Y"])
        if st.W is not None:
            st.W.copy_(tree["W"])
        st.num_updates = int(extra["num_updates"])
        return st
