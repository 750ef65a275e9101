"""Nystrom approximation on one device (the reference's Alg. 2 oracle).

For a symmetric A (n x n): B = A·Omega (n x r), C = Omega^T·B (r x r), and
Ã = B · C† · B^T.  The distributed variants are a later slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from .sketch import omega_tile, validate_kind


def nystrom_reference(A: torch.Tensor, seed, r: int, kind: str = "normal"):
    """(B, C) with Omega materialized (the same Philox Omega as every other
    path)."""
    validate_kind(kind)
    om = omega_tile(seed, 0, 0, A.shape[0], r, kind, A.dtype,
                    device=A.device)
    B = A @ om
    return B, om.T @ B


def _default_rcond(dtype) -> float:
    """1e-12 in float64 (the paper's FP64 cutoff); in reduced precision
    the cutoff sits above the dtype's noise floor."""
    return 1e-12 if dtype == torch.float64 else 1e-6


def reconstruct(B: torch.Tensor, C: torch.Tensor,
                rcond: Optional[float] = None) -> torch.Tensor:
    """Ã = B C† B^T, the pseudo-inverse from an eigendecomposition of the
    symmetrized C with a relative eigenvalue cutoff."""
    rcond = _default_rcond(C.dtype) if rcond is None else rcond
    w, V = torch.linalg.eigh((C + C.T) / 2)
    cutoff = rcond * w.abs().max()
    w_inv = torch.where(w.abs() > cutoff, 1.0 / w, torch.zeros_like(w))
    Cd = (V * w_inv[None, :]) @ V.T
    return B @ Cd @ B.T


def relative_error(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                   rcond: Optional[float] = None) -> torch.Tensor:
    """|| A - Ã ||_F / || A ||_F  (the paper's Tab. 2 metric)."""
    return (torch.linalg.norm(A - reconstruct(B, C, rcond))
            / torch.linalg.norm(A))
