"""Plain torch oracles of the sketch kernels.

Omega comes from the plain Philox at global coordinates, so oracle and
kernel agree bitwise on Omega and to f32 accumulation order on products.
"""
from __future__ import annotations

import torch

from repro_torch.core.kinds import DENSE_KINDS
from repro_torch.core.sketch import (_omega_tile_torch, resolve_device,
                                     seed_keys)


def omega_ref(seed: int, n2: int, r: int, kind: str = "normal",
              salt: int = 0, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """The (n2, r) Omega from the plain Philox; ``device=None`` means the
    card."""
    if kind not in DENSE_KINDS:
        raise ValueError(kind)
    key0, key1 = seed_keys(seed)
    return _omega_tile_torch(key0, key1, 0, 0, n2, r, kind, salt, None,
                             None, resolve_device(device)).to(dtype)


def sketch_matmul_ref(A: torch.Tensor, seed: int, r: int,
                      kind: str = "normal", salt: int = 0,
                      out_dtype=None) -> torch.Tensor:
    """B = A @ Omega, f32 accumulation."""
    om = omega_ref(seed, A.shape[-1], r, kind, salt, device=A.device)
    return (A.to(torch.float32) @ om).to(out_dtype or A.dtype)


def sketch_t_matmul_ref(B: torch.Tensor, seed: int, r: int,
                        kind: str = "normal", salt: int = 0,
                        out_dtype=None) -> torch.Tensor:
    """C = Omega^T @ B, f32 accumulation; Omega is (n x r)."""
    om = omega_ref(seed, B.shape[0], r, kind, salt, device=B.device)
    return (om.T @ B.to(torch.float32)).to(out_dtype or B.dtype)
