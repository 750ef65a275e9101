"""Build the port's CUDA kernels with ``nvcc`` at first use, load with ctypes.

The sources are ``kernels/csrc/*.cu`` (with their ``*.cuh`` headers) and
nothing else.  Each source compiles to an object by its own ``nvcc``, all
started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c

(no ``--use_fast_math``: it flushes denormals), and the objects link into
one shared library with a plain C interface, written to
``build/repro_torch/lib<hash of the sources>.so`` at the repository root, so
an edited source builds anew and an unchanged one is reused.  Nothing here
runs at import: the CPU tests import every module, and a host without
``nvcc`` fails only when a kernel is asked for.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_VP, _U32, _INT, _LL, _F32 = (ctypes.c_void_p, ctypes.c_uint32,
                              ctypes.c_int, ctypes.c_longlong, ctypes.c_float)
_PI = ctypes.POINTER(ctypes.c_int)
_OMEGA = (_U32, _U32, _U32, _U32, _U32, _INT, _F32, _VP)
SIGNATURES = {
    "rt_gen_omega": (_VP, _INT, _INT) + _OMEGA,
    "rt_sketch_fwd": (_VP,) * 5 + (_INT,) * 6 + _OMEGA,
    "rt_sketch_t": (_VP,) * 5 + (_INT,) * 6 + _OMEGA,
    "rt_fold_rows": (_VP, _VP),
    "rt_gemm": (_VP,) * 5 + (_INT,) * 3 + (_LL, _LL, _INT, _INT, _F32, _INT,
                                          _VP),
    "rt_sparse_fold": (_VP,) + (_INT,) * 4 + (_LL, _LL) + (_VP,) * 6
                      + (_INT,) * 7 + (_VP,),
    "rt_sketch_fwd_smem": (_INT, _PI, _PI),
    "rt_sketch_t_smem": (_PI, _PI),
    "rt_fold_rows_smem": (_PI, _PI),
    "rt_sparse_fold_smem": (_INT, _PI, _PI),
}


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``/usr/local/cuda/bin`` or ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin"
                          / "nvcc")
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of repro_torch need the CUDA "
            "toolkit to build")
    return found


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run(procs) -> None:
    """Wait for every (command, process) pair; raise on the first that
    failed, with its output."""
    failed = None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")


def build() -> pathlib.Path:
    """Compile the library unless this source hash is already built;
    returns its path.  One ``nvcc -c`` per source runs in parallel, then
    one link.  The output is written under a temporary name and renamed,
    so concurrent builders never load a half-written file."""
    lib = BUILD_DIR / f"lib{source_hash()}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs, procs = [], []
        for src in sources():
            obj = str(pathlib.Path(work) / (src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        _run(procs)
        tmp = str(pathlib.Path(work) / "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True))])
        os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's argtypes."""
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib
