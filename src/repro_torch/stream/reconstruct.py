"""One-pass low-rank reconstruction from (Y, W) sketch state.

Tropp et al. 2017, Algorithms 4/7: with Y = A·Omega and W = Psi·A,

    Q, _  = qr(Y)                       # orthonormal range basis (n1 x r)
    X     = (Psi·Q)† · W                # least-squares fit      (r  x n2)
    A_hat = Q · X

with an optional fixed-rank truncation (SVD of the small X factor).  Psi is
regenerated from the stream seed (the gen-Omega kernel on the card).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .state import StreamConfig, psi_matrix


class LowRank(NamedTuple):
    """A_hat = Q @ X with Q (n1, k) orthonormal and X (k, n2)."""
    Q: torch.Tensor
    X: torch.Tensor

    @property
    def rank(self) -> int:
        return self.Q.shape[1]

    def matrix(self) -> torch.Tensor:
        return self.Q @ self.X


def lstsq_svd(a: torch.Tensor, b: torch.Tensor,
              rcond: Optional[float] = None) -> torch.Tensor:
    """Minimum-norm least-squares solution of ``a x = b`` through the SVD,
    dropping singular values below ``rcond * s_max``.  The default cutoff
    is numpy's and JAX's, ``eps(dtype) * max(m, n)``.  (torch's own
    ``lstsq`` on CUDA supports only ``gels``, which ignores ``rcond``.)"""
    m, n = a.shape
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(m, n)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    return vt.T @ (s_inv[:, None] * (u.T @ b))


def one_pass_reconstruct(Y: torch.Tensor, W: torch.Tensor, cfg: StreamConfig,
                         rank: Optional[int] = None,
                         rcond: Optional[float] = None) -> LowRank:
    """A ~= Q·(Psi Q)†·W, optionally truncated to ``rank``."""
    Q, _ = torch.linalg.qr(Y)
    PsiQ = psi_matrix(cfg, device=Y.device).to(Q.dtype) @ Q      # (l, r)
    X = lstsq_svd(PsiQ, W.to(Q.dtype), rcond)
    if rank is not None and rank < X.shape[0]:
        U, s, Vt = torch.linalg.svd(X, full_matrices=False)
        Q = Q @ U[:, :rank]
        X = s[:rank, None] * Vt[:rank]
    return LowRank(Q, X)


def reconstruction_error(A: torch.Tensor, approx: LowRank) -> torch.Tensor:
    """|| A - Q X ||_F / || A ||_F."""
    return torch.linalg.norm(A - approx.matrix()) / torch.linalg.norm(A)
