"""Core: Omega draws at global coordinates and the one-device oracles."""
from . import kinds, rng, sketch, nystrom  # noqa: F401

from .kinds import (  # noqa: F401
    DENSE_KINDS, SPARSE_KINDS, VALID_KINDS, validate_kind,
)
from .sketch import (  # noqa: F401
    omega_tile, resolve_device, seed_keys, sketch_reference,
    sketch_sparse_apply, sparse_omega_map, sparse_omega_rows,
)
from .nystrom import (  # noqa: F401
    nystrom_reference, reconstruct, relative_error,
)
