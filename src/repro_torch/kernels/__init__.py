"""Hand-written Hopper kernels of the sketch GEMMs, the row-slab fold, the
dense GEMM of the gradient exchange and the sparse fold (``csrc/``), their
ctypes launchers with launch counters, and their plain torch versions."""
from .ops import (  # noqa: F401
    gen_omega, nystrom_fused, sketch_matmul, sketch_t_matmul,
)
from .sketch_matmul import (  # noqa: F401
    LAUNCHES, fold_rows_cuda, gemm_cuda, gen_omega_cuda, reset_launches,
    sketch_fwd_cuda, sketch_t_cuda, sparse_fold_cuda,
)
from .local import (  # noqa: F401
    BACKENDS, fold_rows_block, gemm_block, resolve_backend, sketch_block,
    sketch_t_block, sparse_fold_block,
)
from . import local, ref  # noqa: F401
