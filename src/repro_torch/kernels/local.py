"""The two local sketch GEMMs every one-device path runs through.

  * ``sketch_block``    —  acc? + A · Omega[row0:, col0:col0+cols]
  * ``sketch_t_block``  —  acc? + Omega[row0:, col0:col0+cols]^T · B

with the Omega (or Psi) tile drawn at GLOBAL Philox coordinates, so the
key pair and the offsets select any shard's block.  ``acc`` fuses the
streaming accumulation ``Y += H·Omega``: the result is written into
``acc`` IN PLACE (the reference rebinds an immutable array instead).

Backends (one spelling across the port):

  * ``"cuda"``  — the hand-written kernel (``csrc/sketch_kernels.cu``);
                  Omega is generated in shared memory and never stored.
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

from typing import Optional

import torch

from repro_torch.core.sketch import _omega_tile_torch, seed_keys
from repro_torch.core.kinds import validate_kind

from .sketch_matmul import sketch_fwd_cuda, sketch_t_cuda

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

def _check_acc(acc, shape, out_dtype) -> None:
    """The plain path's copy of the launcher's ``acc`` contract, so both
    paths refuse the same ``acc``."""
    if acc is not None and (tuple(acc.shape) != tuple(shape)
                            or acc.dtype != out_dtype
                            or not acc.is_contiguous()):
        raise ValueError(f"acc must be a contiguous {out_dtype} tensor of "
                         f"shape {tuple(shape)}, got {tuple(acc.shape)} "
                         f"{acc.dtype}")


def _dispatch(kernel, plain, X, seed, cols, out_shape, row0, col0, kind,
              salt, scale, acc, out_dtype, backend):
    validate_kind(kind)
    out_dtype = out_dtype or X.dtype
    if resolve_backend(backend, X.device) == "torch":
        _check_acc(acc, out_shape, out_dtype)
        out = plain(X, seed, cols, row0, col0, kind, salt, scale, acc,
                    out_dtype)
        return out if acc is None else acc.copy_(out)
    key0, key1 = seed_keys(seed)
    return kernel(X.contiguous(), key0, key1, cols, row0, col0, kind, salt,
                  scale, acc, out_dtype)


def sketch_block(A: torch.Tensor, seed, cols: int, *, row0=0, col0=0,
                 kind: str = "normal", salt: int = 0, scale=None,
                 acc: Optional[torch.Tensor] = None, out_dtype=None,
                 backend: str = "auto") -> torch.Tensor:
    """``acc? + A @ Omega[row0:row0+k, col0:col0+cols]`` (k = A.shape[1]).

    The local body of Alg. 1 and of the streaming range update.  ``seed``
    is an int or a (2,) key pair.  The result has ``out_dtype`` (default
    A's dtype); with ``acc`` (contiguous, of that dtype) it is written
    into ``acc`` in place and ``acc`` is returned.
    """
    return _dispatch(sketch_fwd_cuda, _sketch_block_torch, A, seed, cols,
                     (A.shape[0], cols), row0, col0, kind, salt, scale, acc,
                     out_dtype, backend)


def sketch_t_block(B: torch.Tensor, seed, cols: int, *, row0=0, col0=0,
                   kind: str = "normal", salt: int = 0, scale=None,
                   acc: Optional[torch.Tensor] = None, out_dtype=None,
                   backend: str = "auto") -> torch.Tensor:
    """``acc? + Omega[row0:row0+n, col0:col0+cols]^T @ B`` (n = B.shape[0]).

    The Nystrom second stage (C = Omega^T·B) and the streaming co-range
    update (W += Psi·H under Psi's salt).  Same contract as
    :func:`sketch_block`.
    """
    return _dispatch(sketch_t_cuda, _sketch_t_block_torch, B, seed, cols,
                     (cols, B.shape[1]), row0, col0, kind, salt, scale, acc,
                     out_dtype, backend)
