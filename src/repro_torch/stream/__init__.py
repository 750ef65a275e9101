"""Streaming one-pass sketches on one device: (Y = A·Omega, W = Psi·A)
with Omega/Psi regenerated by the fused kernels.

  state.py        — StreamConfig + StreamingSketch (row/col/additive
                    ingest, in place)
  reconstruct.py  — one-pass fixed-rank A ~= Q·(Psi Q)†·W (Tropp et al.)
"""
from .state import (  # noqa: F401
    OMEGA_SALT, PSI_SALT, StreamConfig, StreamingSketch, nystrom_local,
    omega_matrix, psi_cols, psi_matrix, validate_row_block,
)
from .reconstruct import (  # noqa: F401
    LowRank, lstsq_svd, one_pass_reconstruct, reconstruction_error,
)
