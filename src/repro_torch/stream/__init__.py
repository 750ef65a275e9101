"""Streaming one-pass sketches on one device: (Y = A·Omega, W = Psi·A)
with Omega/Psi regenerated by the fused kernels.

  state.py        — StreamConfig + StreamingSketch (row/col/additive
                    ingest, in place), the solo and lane-batched row-slab
                    updates the service runs
  reconstruct.py  — one-pass fixed-rank A ~= Q·(Psi Q)†·W (Tropp et al.)
  service.py      — SketchService: many concurrent streams on one card,
                    ragged multi-tenant ingest, QoS + LRU admission with
                    eviction to host memory
  ingest.py       — IngestQueue: bounded async request queue with
                    backpressure, retries and poison-lane excision
  wal.py          — WriteAheadLog: journal of accepted updates; replay
                    onto a fresh service is bitwise
  faults.py       — the fault-point registry the ingest path fires
"""
from .state import (  # noqa: F401
    OMEGA_SALT, PSI_SALT, StreamConfig, StreamingSketch, nystrom_local,
    omega_matrix, pow2_bucket, psi_cols, psi_matrix, snap_bucket,
    validate_row_block,
)
from .reconstruct import (  # noqa: F401
    LowRank, lstsq_svd, one_pass_reconstruct, reconstruction_error,
)
from .service import QOS_CLASSES, SketchService  # noqa: F401
from .ingest import IngestQueue, WorkerDied  # noqa: F401
from .wal import WalRecord, WriteAheadLog  # noqa: F401
from .wal import replay as wal_replay  # noqa: F401
from . import faults  # noqa: F401
