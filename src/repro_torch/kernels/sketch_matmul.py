"""Launchers of the three CUDA sketch kernels, with their launch counters.

The counterpart of the reference's Pallas kernel module: where that one
defines ``gen_omega_pallas``, ``sketch_matmul_pallas`` and
``sketch_t_matmul_pallas``, this one launches the hand-written Hopper
kernels of ``csrc/sketch_kernels.cu`` that replace them:

  * ``gen_omega_cuda``  — a materialized Omega tile (the K1 generator's
                          oracle, K8);
  * ``sketch_fwd_cuda`` — ``acc? + A · Omega[row0:, col0:col0+cols]``
                          (K2, and K6 at offset 0);
  * ``sketch_t_cuda``   — ``acc? + Omega[row0:, col0:col0+cols]^T · B``
                          (K3, and K7 at offset 0).

Keys, offsets, salt, kind and scale are runtime arguments, so one build
serves every seed and shard offset.  Each launcher checks device, dtype,
shape and contiguity, launches on the current stream without
synchronizing, raises if the launch was refused, and adds one to
``LAUNCHES[name]`` where (and only where) it launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

MASK32 = 0xFFFFFFFF
KIND_CODES = {"normal": 0, "uniform": 1, "rademacher": 2}
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2 ** 31 - 1

# Launches of each kernel since the last ``reset_launches()``.
LAUNCHES = {"gen_omega": 0, "sketch_fwd": 0, "sketch_t": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kind_code(kind: str) -> int:
    if kind not in KIND_CODES:
        raise ValueError(f"no CUDA kernel for omega kind {kind!r}; the "
                         f"kernels draw {', '.join(KIND_CODES)}")
    return KIND_CODES[kind]


def _omega_args(key0, key1, row0, col0, salt, kind, scale):
    return (int(key0) & MASK32, int(key1) & MASK32, int(row0) & MASK32,
            int(col0) & MASK32, int(salt) & MASK32, _kind_code(kind),
            1.0 if scale is None else float(scale))


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = _build.library().rt_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {rc} ({msg})")


def _check_operand(X: torch.Tensor, name: str) -> None:
    if not X.is_cuda:
        raise ValueError(f"{name}: operand must be a CUDA tensor, got "
                         f"{X.device}")
    if X.dim() != 2 or X.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: operand must be a 2-D float32/bfloat16 "
                         f"tensor, got {tuple(X.shape)} {X.dtype}")
    if not X.is_contiguous():
        raise ValueError(f"{name}: operand must be contiguous")


def _output(acc: Optional[torch.Tensor], shape, out_dtype, device,
            name: str) -> torch.Tensor:
    """``acc`` itself (the kernel accumulates into it in place) or a new
    tensor."""
    if out_dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name}: out_dtype must be float32 or bfloat16, "
                         f"got {out_dtype}")
    if acc is None:
        return torch.empty(shape, dtype=out_dtype, device=device)
    if (acc.device != device or tuple(acc.shape) != tuple(shape)
            or acc.dtype != out_dtype or not acc.is_contiguous()):
        raise ValueError(f"{name}: acc must be a contiguous {out_dtype} "
                         f"tensor of shape {tuple(shape)} on {device}, got "
                         f"{tuple(acc.shape)} {acc.dtype} on {acc.device}")
    return acc


def gen_omega_cuda(key0: int, key1: int, row0: int, col0: int, rows: int,
                   cols: int, kind: str, salt: int = 0,
                   device=None) -> torch.Tensor:
    """Omega[row0:row0+rows, col0:col0+cols] as float32, drawn on the card."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"gen_omega_cuda needs a CUDA device, got {device}")
    if not (0 <= rows <= _INT_MAX and 0 <= cols <= _INT_MAX):
        raise ValueError(f"bad tile shape ({rows}, {cols})")
    args = _omega_args(key0, key1, row0, col0, salt, kind, None)
    out = torch.empty((rows, cols), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(device):
        rc = lib.rt_gen_omega(out.data_ptr(), rows, cols, *args,
                              _stream(device))
        LAUNCHES["gen_omega"] += 1
    _raise_on(rc, "gen_omega")
    return out


def _gemm(name: str, X: torch.Tensor, out_shape, m: int, n: int, K: int,
          key0, key1, row0, col0, kind, salt, scale, acc, out_dtype):
    _check_operand(X, name)
    args = _omega_args(key0, key1, row0, col0, salt, kind, scale)
    if max(m, n, K) > _INT_MAX:
        raise ValueError(f"{name}: dims ({m}, {n}, {K}) exceed int32")
    out = _output(acc, out_shape, out_dtype, X.device, name)
    if m == 0 or n == 0:
        return out
    lib = _build.library()
    fn = lib.rt_sketch_fwd if name == "sketch_fwd" else lib.rt_sketch_t
    with torch.cuda.device(X.device):
        rc = fn(X.data_ptr(), None if acc is None else acc.data_ptr(),
                out.data_ptr(), *((m, K, n) if name == "sketch_fwd"
                                  else (K, n, m)),
                int(X.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16), *args, _stream(X.device))
        LAUNCHES[name] += 1
    _raise_on(rc, name)
    return out


def sketch_fwd_cuda(A: torch.Tensor, key0: int, key1: int, cols: int,
                    row0: int = 0, col0: int = 0, kind: str = "normal",
                    salt: int = 0, scale=None,
                    acc: Optional[torch.Tensor] = None,
                    out_dtype=None) -> torch.Tensor:
    """``acc? + A @ Omega[row0:row0+k, col0:col0+cols]`` on the card.

    ``A`` (m, k) float32/bfloat16, contiguous; Omega is generated inside
    the kernel.  With ``acc`` the result is written into ``acc`` in place.
    """
    m, K = A.shape
    out_dtype = out_dtype or A.dtype
    return _gemm("sketch_fwd", A, (m, cols), m, cols, K, key0, key1, row0,
                 col0, kind, salt, scale, acc, out_dtype)


def sketch_t_cuda(B: torch.Tensor, key0: int, key1: int, cols: int,
                  row0: int = 0, col0: int = 0, kind: str = "normal",
                  salt: int = 0, scale=None,
                  acc: Optional[torch.Tensor] = None,
                  out_dtype=None) -> torch.Tensor:
    """``acc? + Omega[row0:row0+k, col0:col0+cols]^T @ B`` on the card.

    ``B`` (k, r2) float32/bfloat16, contiguous; the result is (cols, r2).
    """
    K, r2 = B.shape
    out_dtype = out_dtype or B.dtype
    return _gemm("sketch_t", B, (cols, r2), cols, r2, K, key0, key1, row0,
                 col0, kind, salt, scale, acc, out_dtype)
