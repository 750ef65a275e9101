"""Omega draws at global coordinates, and the one-device sketch oracles.

Entry values depend only on (seed, salt, global coordinate), never on the
tiling, so any shard regenerates exactly the block it consumes.  On the
card the dense kinds are drawn by the gen-Omega CUDA kernel
(``kernels/csrc/sketch_kernels.cu``); on the CPU, and for the sparse kinds
(which have no kernel) on any device, by the plain Philox of ``rng.py``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import rng
from .kinds import DENSE_KINDS, SPARSE_KINDS, VALID_KINDS, validate_kind
from .rng import resolve_device

__all__ = ["DENSE_KINDS", "SPARSE_KINDS", "VALID_KINDS", "validate_kind",
           "resolve_device", "seed_keys", "omega_tile", "sparse_omega_map",
           "sparse_omega_rows", "sketch_sparse_apply", "sketch_reference"]


def seed_keys(seed):
    """The Philox (key0, key1) pair of a seed, as two ints in [0, 2**32).

    ``seed`` may be a Python int (split into its low and high uint32
    halves), a shape-(2,) key pair, or a 0-d array/tensor ``s`` (which
    gives ``(s, 0)``, not a split, as in the reference).
    """
    if isinstance(seed, (int, np.integer)):
        seed = int(seed)
        return seed & rng.MASK32, (seed >> 32) & rng.MASK32
    arr = (seed.detach().cpu().numpy() if isinstance(seed, torch.Tensor)
           else np.asarray(seed))
    if arr.shape == (2,):
        return int(arr[0]) & rng.MASK32, int(arr[1]) & rng.MASK32
    if arr.shape == ():
        return int(arr) & rng.MASK32, 0
    raise ValueError(f"seed must be an int, a scalar, or a (2,) key pair; "
                     f"got shape {arr.shape}")


def _omega_tile_torch(key0: int, key1: int, row0, col0, rows: int,
                      cols: int, kind: str, salt: int,
                      r_total: Optional[int], n_total: Optional[int],
                      device) -> torch.Tensor:
    """The plain float32 tile (the gen-Omega kernel's reference)."""
    if kind == "normal":
        return rng.philox_normal_grid(key0, key1, row0, col0, rows, cols,
                                      salt, device)
    if kind in ("uniform", "rademacher"):
        u = rng.philox_uniform_grid(key0, key1, row0, col0, rows, cols,
                                    salt, device)
        if kind == "uniform":
            return u
        one = torch.ones((), dtype=torch.float32, device=device)
        return torch.where(u < 0.5, -one, one)
    r_total = cols if r_total is None else r_total
    if kind == "countsketch":
        return rng.philox_countsketch_grid(key0, key1, row0, col0, rows,
                                           cols, r_total, salt, device)
    return rng.philox_rowsample_grid(
        key0, key1, row0, col0, rows, cols, r_total,
        rows if n_total is None else n_total, salt, device)


def omega_tile(seed, row0, col0, rows: int, cols: int,
               kind: str = "normal", dtype=torch.float32, salt: int = 0,
               r_total: Optional[int] = None, n_total: Optional[int] = None,
               device=None) -> torch.Tensor:
    """Tile [row0:row0+rows, col0:col0+cols] of the global Omega.

    ``r_total``/``n_total`` are the global column/row counts the sparse
    kinds need (defaults: a full-width, full-height tile); dense kinds
    ignore them.  ``device=None`` means the card.
    """
    validate_kind(kind)
    device = resolve_device(device)
    key0, key1 = seed_keys(seed)
    if kind in DENSE_KINDS and device.type == "cuda":
        from repro_torch.kernels.sketch_matmul import gen_omega_cuda
        t = gen_omega_cuda(key0, key1, int(row0), int(col0), rows, cols,
                           kind, salt, device=device)
    else:
        t = _omega_tile_torch(key0, key1, int(row0), int(col0), rows, cols,
                              kind, salt, r_total, n_total, device)
    return t.to(dtype)


def sparse_omega_map(seed, n_rows: int, width: int, kind: str,
                     dtype=torch.float32, salt: int = 0, row0=0,
                     n_total: Optional[int] = None, device=None):
    """Per-row (bucket, value) of a sparse Omega row range:
    ``Omega[row0 + i, bucket[i]] = value[i]`` (value 0: row not sampled).
    ``width`` is Omega's global column count, ``n_total`` its global row
    count (default ``n_rows``)."""
    validate_kind(kind)
    if kind not in SPARSE_KINDS:
        raise ValueError(f"kind {kind!r} is dense; sparse_omega_map serves "
                         f"{', '.join(SPARSE_KINDS)}")
    device = resolve_device(device)
    g = (int(row0) + torch.arange(n_rows, device=device)) & rng.MASK32
    return sparse_omega_rows(seed, g, width, kind, dtype, salt,
                             n_rows if n_total is None else n_total)


def sparse_omega_rows(seed, g, width: int, kind: str, dtype=torch.float32,
                      salt: int = 0, n_total: Optional[int] = None):
    """(bucket, value) draws at a tensor ``g`` of global row indices (any
    repetition); draws depend only on ``g[i]``, so gathering per stored
    entry is bitwise the slice of the full map.  Follows ``g``'s device."""
    validate_kind(kind)
    if kind not in SPARSE_KINDS:
        raise ValueError(f"kind {kind!r} is dense; sparse_omega_rows serves "
                         f"{', '.join(SPARSE_KINDS)}")
    key0, key1 = seed_keys(seed)
    g = torch.as_tensor(g).to(torch.int64) & rng.MASK32
    bucket, sign = rng.philox_countsketch_rows(key0, key1, g, width, salt)
    if kind == "countsketch":
        value = sign
    else:
        if n_total is None:
            raise ValueError("rowsample draws need n_total (global rows)")
        value = rng._rowsample_values(key0, key1, g, sign, width, n_total,
                                      salt)
    return bucket, value.to(dtype)


def sketch_sparse_apply(A: torch.Tensor, seed, r: int,
                        kind: str = "countsketch",
                        salt: int = 0) -> torch.Tensor:
    """B = A @ Omega for a sparse Omega without materializing it: one
    scatter-add (``index_add_``) per stored entry of A.  Equal to the
    dense product up to summation order."""
    validate_kind(kind)
    if kind not in SPARSE_KINDS:
        raise ValueError(f"kind {kind!r} is dense; use sketch_reference")
    n2 = A.shape[-1]
    bucket, value = sparse_omega_map(seed, n2, r, kind, A.dtype, salt,
                                     device=A.device)
    out = torch.zeros((*A.shape[:-1], r), dtype=A.dtype, device=A.device)
    return out.index_add_(-1, bucket, A * value)


def sketch_reference(A: torch.Tensor, seed, r: int, kind: str = "normal",
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-device oracle: B = A @ Omega with the full Omega materialized."""
    validate_kind(kind)
    om = omega_tile(seed, 0, 0, A.shape[-1], r, kind, A.dtype,
                    device=A.device)
    if scale is not None:
        om = om * torch.tensor(scale, dtype=A.dtype, device=A.device)
    return A @ om

