"""One-pass streaming sketch state on one device (Tropp et al. 2017).

The sketches are linear in A, so for any additive update

    A  <-  A + H      =>      Y  <-  Y + H·Omega ,   W  <-  W + Psi·H

with Y = A·Omega (n1 x r) the range sketch and W = Psi·A (l x n2) the
co-range sketch.  Omega and Psi are regenerated from the seed under two
salts, so only the O((n1 + n2)·r) sketch state is stored.

For the dense kinds every update runs through the fused kernels of
``kernels/local.py`` (on the card, the CUDA kernels; Omega and Psi never
exist in device memory).  The sparse kinds have no kernel: they materialize
their tile and multiply, on any device, as the reference does.

Unlike the reference, whose updates rebind immutable arrays, the updates
here write into ``Y`` and ``W`` IN PLACE.

Each Y row is produced by one full-contraction kernel call whose per-
element summation order does not depend on the slab height, so a
row-partitioned stream reproduces the one-shot sketch of the same kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.kinds import SPARSE_KINDS, validate_kind
from repro_torch.core.sketch import omega_tile, resolve_device, seed_keys
from repro_torch.kernels.local import (resolve_backend, sketch_block,
                                       sketch_t_block)

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


def nystrom_local(Y: torch.Tensor, cfg: StreamConfig):
    """(B, C) of a symmetric stream: C = Omega^T·Y from the sketch alone."""
    if cfg.kind in SPARSE_KINDS:
        om = omega_tile(cfg.seed, 0, 0, cfg.n2, cfg.r, cfg.kind, Y.dtype,
                        salt=cfg.omega_salt, device=Y.device)
        return Y, om.T @ Y
    return Y, sketch_t_block(Y, cfg.seed, cfg.r, kind=cfg.kind,
                             salt=cfg.omega_salt)


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
        cfg = self.cfg
        validate_row_block(cfg, row0, tuple(H.shape))
        H = self._as_slab(H)
        k = H.shape[0]
        Yk = self.Y[row0:row0 + k]            # a contiguous row view
        if cfg.kind in SPARSE_KINDS:
            Yk += H @ omega_matrix(cfg, device=self.device)
            if self.W is not None:
                self.W += psi_cols(cfg, row0, k, device=self.device).T @ H
        else:
            sketch_block(H, self.keys, cfg.r, acc=Yk,
                         **self._kw(cfg.omega_salt))
            if self.W is not None:
                sketch_t_block(H, self.keys, cfg.sketch_l, row0=row0,
                               acc=self.W, **self._kw(cfg.psi_salt))
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
