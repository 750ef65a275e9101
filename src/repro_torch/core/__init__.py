"""Core: Omega draws at global coordinates, the one-device oracles, the
communication bounds and grids, and Alg. 1 and Alg. 2 (1-D and two-grid)
on torch.distributed."""
from . import kinds, rng, sketch, nystrom, lower_bounds, grid  # noqa: F401

from .kinds import (  # noqa: F401
    DENSE_KINDS, SPARSE_KINDS, VALID_KINDS, validate_kind,
)
from .sketch import (  # noqa: F401
    GridGroups, gather_output, input_block, make_grid_groups, omega_tile,
    output_block, rand_matmul, rand_matmul_auto, rand_matmul_communicating,
    resolve_device, seed_keys, sketch_reference, sketch_sparse_apply,
    sparse_omega_map, sparse_omega_rows,
)
from .nystrom import (  # noqa: F401
    nystrom_auto, nystrom_block, nystrom_gather, nystrom_general,
    nystrom_no_redist, nystrom_redist, nystrom_reference,
    nystrom_second_stage_no_redist, nystrom_second_stage_redist,
    nystrom_second_stage_two_grid, nystrom_second_stage_two_grid_fused,
    nystrom_two_grid, nystrom_two_grid_fused, permuted_grid_groups,
    reconstruct, relative_error, two_grid_block, two_grid_gather,
)
from .lower_bounds import (  # noqa: F401
    gemm_lower_bound, matmul_lower_bound, matmul_regime, nystrom_lower_bound,
    nystrom_regime,
)
from .grid import (  # noqa: F401
    MatmulGrid, NystromGrids, TwoGridSharedMesh, alg1_bandwidth_words,
    alg1_latency_hops, alg2_bandwidth_words, alg2_two_grid_executable,
    factorizations_3d, select_matmul_grid, select_nystrom_grids,
    select_two_grid_executable, two_grid_axis_split, two_grid_shared_mesh,
)
