"""One-device sketch entry points (the reference's ``kernels/ops.py``).

They launch the same kernels as ``kernels/local.py`` with
``row0 = col0 = 0``.  The kernels mask ragged edges themselves, so no
shape is padded; in-range entries keep their global coordinates.
"""
from __future__ import annotations

import torch

from repro_torch.core.sketch import omega_tile

from .local import sketch_block, sketch_t_block


def sketch_matmul(A: torch.Tensor, *, seed: int, r: int,
                  kind: str = "normal", salt: int = 0) -> torch.Tensor:
    """B = A @ Omega(n2, r) with Omega drawn on the card inside the call."""
    return sketch_block(A, seed, r, kind=kind, salt=salt)


def sketch_t_matmul(B: torch.Tensor, *, seed: int, r: int,
                    kind: str = "normal", salt: int = 0) -> torch.Tensor:
    """C = Omega(n, r)^T @ B with Omega drawn on the card inside the call."""
    return sketch_t_block(B, seed, r, kind=kind, salt=salt)


def gen_omega(*, seed: int, n2: int, r: int, kind: str = "normal",
              salt: int = 0, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """Materialize Omega with the kernel's generator (``device=None``: the
    card)."""
    return omega_tile(seed, 0, 0, n2, r, kind, dtype, salt=salt,
                      device=device)


def nystrom_fused(A: torch.Tensor, *, seed: int, r: int,
                  kind: str = "normal"):
    """(B, C) of the Nystrom pair with Omega never kept: B = A·Omega,
    then C = Omega^T·B, both through the kernels, each of which draws its
    Omega slab into a scratch that lives for one call."""
    B = sketch_matmul(A, seed=seed, r=r, kind=kind)
    C = sketch_t_matmul(B, seed=seed, r=r, kind=kind)
    return B, C
