"""Philox-4x32-10 in plain torch: the bitwise reference of the Omega draws.

Omega is never stored or sent: any processor regenerates the block it
consumes from a shared seed with the counter-based Philox-4x32-10 keyed by
GLOBAL coordinates, so every tile decomposition draws identical entries.
This module is the plain version of that generator; the CUDA kernels
(``kernels/csrc/philox.cuh``) compute the same bits on the card.

uint32 arithmetic is emulated in int64 tensors holding values in
[0, 2**32) and masked with ``& 0xFFFFFFFF``: torch has no right shift on
``torch.uint32`` CPU tensors, and a 32x32 product in int64 can overflow,
so ``_mulhilo32`` multiplies 16-bit limbs (every partial product stays
below 2**50).

Normal entries use the Irwin-Hall sum of 12 uniform 24-bit lanes: integer
adds are exact, the single int->f32 convert rounds to nearest even on every
device, and the scale by 2**-24 is exact, so an entry's bits depend only on
(seed, salt, global coordinate).
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9  # golden ratio
PHILOX_W1 = 0xBB67AE85  # sqrt(3) - 1
PHILOX_ROUNDS = 10

COUNTSKETCH_LANE = 4   # c3 lane of the bucket/sign stream
ROWSAMPLE_LANE = 5     # c3 lane of the coordinated-membership stream

_TWO_M24 = 1.0 / (1 << 24)   # exact in float32


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without CUDA that raises: the port never
    drops to the CPU unless the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device=\"cpu\" to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _u32(x, device=None) -> torch.Tensor:
    """An int64 tensor holding ``x mod 2**32``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return torch.tensor(int(x) & MASK32, dtype=torch.int64, device=device)


def _mulhilo32(a, b):
    """(hi, lo) of the 32x32->64 bit product, from 16-bit limbs.

    ``a``/``b`` are int64 tensors (or Python ints) in [0, 2**32).  With
    ``t = a_lo*b_lo + (a_lo*b_hi + a_hi*b_lo) << 16`` (< 2**50) the
    product is ``a_hi*b_hi * 2**32 + t``, so no intermediate overflows.
    """
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    t = a_lo * b_lo + ((a_lo * b_hi + a_hi * b_lo) << 16)
    return (a_hi * b_hi + (t >> 32)) & MASK32, t & MASK32


def philox_4x32(counter, key, rounds: int = PHILOX_ROUNDS):
    """Philox-4x32 with ``rounds`` rounds (default 10, the standard).

    ``counter`` is a 4-tuple and ``key`` a 2-tuple of int64 tensors (or
    ints) of broadcastable shapes holding uint32 values.  Returns four
    int64 tensors of the broadcast shape.
    """
    dev = next((t.device for t in (*counter, *key)
                if isinstance(t, torch.Tensor)), None)
    c0, c1, c2, c3 = (_u32(c, dev) for c in counter)
    k0, k1 = _u32(key[0], dev), _u32(key[1], dev)
    shape = torch.broadcast_shapes(c0.shape, c1.shape, c2.shape, c3.shape,
                                   k0.shape, k1.shape)
    for _ in range(rounds):
        hi0, lo0 = _mulhilo32(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & MASK32
        k1 = (k1 + PHILOX_W1) & MASK32
    return tuple(c.expand(shape) for c in (c0, c1, c2, c3))


def _uniform_from_u32(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 uniform in [0, 1) with a 24-bit mantissa."""
    return (bits >> 8).to(torch.float32) * _TWO_M24


def _coords(row0, col0, rows: int, cols: int, device):
    gi = (_u32(row0, device) + torch.arange(rows, device=device)[:, None])
    gj = (_u32(col0, device) + torch.arange(cols, device=device)[None, :])
    return gi & MASK32, gj & MASK32


def philox_uniform_grid(key0, key1, row0, col0, rows: int, cols: int,
                        salt: int = 0, device=None) -> torch.Tensor:
    """A (rows, cols) float32 uniform[0,1) tile at global coordinates
    (row0 + i, col0 + j); counter ``(gi, gj, salt, 0)``."""
    gi, gj = _coords(row0, col0, rows, cols, device)
    r0, _, _, _ = philox_4x32((gi, gj, salt, 0), (key0, key1))
    return _uniform_from_u32(r0)


def philox_normal_grid(key0, key1, row0, col0, rows: int, cols: int,
                       salt: int = 0, device=None) -> torch.Tensor:
    """A (rows, cols) float32 ~N(0,1) tile (Irwin-Hall), bit-exact on
    every device.  Three Philox calls per entry at counters
    ``(gi, gj, salt, sub + 1)`` for sub in 0..2."""
    gi, gj = _coords(row0, col0, rows, cols, device)
    total = torch.zeros((), dtype=torch.int64, device=device)
    for sub in range(3):
        r0, r1, r2, r3 = philox_4x32((gi, gj, salt, sub + 1), (key0, key1))
        total = total + (r0 >> 8) + (r1 >> 8) + (r2 >> 8) + (r3 >> 8)
    d = total - 6 * (1 << 24)                       # exact
    return d.to(torch.float32) * _TWO_M24           # one RNE convert


# ---------------------------------------------------------------------------
# Sparse family draws.  Per ROW: counter (g, 0, salt, lane) with g the
# global row index, so any column slice of row g sees the same draws.
# ---------------------------------------------------------------------------

def philox_countsketch_rows(key0, key1, g, r: int, salt: int = 0):
    """(bucket, sign) draws for global Omega rows ``g`` (int64 tensor of
    uint32 values, any shape): bucket = r0 mod r, sign = +-1 from the low
    bit of r1 (float32)."""
    g = _u32(g)
    r0, r1, _, _ = philox_4x32((g, 0, salt, COUNTSKETCH_LANE), (key0, key1))
    bucket = r0 % int(r)
    one = torch.ones((), dtype=torch.float32, device=g.device)
    sign = torch.where((r1 & 1) == 1, one, -one)
    return bucket, sign


def philox_rowsample_uniform(key0, key1, g, salt: int = 0) -> torch.Tensor:
    """Coordinated membership draw u in [0, 1) at counter
    ``(g, 0, salt, 5)``."""
    g = _u32(g)
    r0, _, _, _ = philox_4x32((g, 0, salt, ROWSAMPLE_LANE), (key0, key1))
    return _uniform_from_u32(r0)


def _rowsample_values(key0, key1, g, sign, r_total: int, n_total: int,
                      salt: int) -> torch.Tensor:
    """sign/sqrt(p) where the row is sampled (u < p), else 0; p and
    1/sqrt(p) are float32 constants of (r_total, n_total)."""
    p = min(1.0, float(r_total) / float(n_total))
    p32 = float(np.float32(p))
    scale = float(np.float32(1.0 / math.sqrt(p)))
    u = philox_rowsample_uniform(key0, key1, g, salt)
    return torch.where(u < p32, sign * scale, torch.zeros_like(sign))


def philox_countsketch_grid(key0, key1, row0, col0, rows: int, cols: int,
                            r_total: int, salt: int = 0,
                            device=None) -> torch.Tensor:
    """Materialized (rows, cols) tile of the CountSketch Omega of global
    width ``r_total``."""
    gi, gj = _coords(row0, col0, rows, cols, device)
    bucket, sign = philox_countsketch_rows(key0, key1, gi[:, 0], r_total,
                                           salt)
    return torch.where(bucket[:, None] == gj, sign[:, None],
                       torch.zeros((), dtype=torch.float32, device=device))


def philox_rowsample_grid(key0, key1, row0, col0, rows: int, cols: int,
                          r_total: int, n_total: int, salt: int = 0,
                          device=None) -> torch.Tensor:
    """Materialized (rows, cols) tile of the coordinated row-sampling
    Omega (global shape ``n_total x r_total``)."""
    gi, gj = _coords(row0, col0, rows, cols, device)
    g = gi[:, 0]
    bucket, sign = philox_countsketch_rows(key0, key1, g, r_total, salt)
    val = _rowsample_values(key0, key1, g, sign, r_total, n_total, salt)
    return torch.where(bucket[:, None] == gj, val[:, None],
                       torch.zeros((), dtype=torch.float32, device=device))


def philox_omega_full(seed: int, n2: int, r: int, dtype=torch.float32,
                      salt: int = 0, device=None) -> torch.Tensor:
    """Full normal Omega from the Philox path.  ``device=None`` means the
    card."""
    return philox_normal_grid(seed & MASK32, (seed >> 32) & MASK32, 0, 0,
                              n2, r, salt=salt,
                              device=resolve_device(device)).to(dtype)
