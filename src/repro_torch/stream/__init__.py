"""Streaming one-pass sketches: (Y = A·Omega, W = Psi·A) with Omega/Psi
regenerated by the fused kernels, on one device or sharded over a grid of
ranks.

  state.py        — StreamConfig + StreamingSketch (row/col/additive and
                    COO row-slab ingest, in place; save / restore),
                    SparseRows, the solo and lane-batched row-slab updates
                    the service runs
  distributed.py  — ShardedStreamingSketch: the (Y, W) state sharded over
                    a (p1, p2, p3) grid of torch.distributed ranks (Alg. 1
                    per update), its checkpoints and streamed Nystrom
                    finalize
  reconstruct.py  — one-pass fixed-rank A ~= Q·(Psi Q)†·W (Tropp et al.)
  service.py      — SketchService: many concurrent streams on one card
                    (ragged multi-tenant ingest) or sharded over a grid,
                    QoS + LRU admission with eviction to host memory or
                    to disk (spill_dir), live reshard of a grid service
  ingest.py       — IngestQueue: bounded async request queue with
                    backpressure, retries and poison-lane excision, for a
                    local or a grid service
  wal.py          — WriteAheadLog: journal of accepted updates; replay
                    onto a fresh service is bitwise
  elastic.py      — reshard_stream / drain_reshard_resume: a live sharded
                    stream moved onto another grid in one hop
  faults.py       — the fault-point registry and the chaos drills
                    (launch/serve.py --chaos)
"""
from .state import (  # noqa: F401
    OMEGA_SALT, PSI_SALT, SparseRows, StreamConfig, StreamingSketch,
    nystrom_local, omega_matrix, pow2_bucket, psi_cols, psi_matrix,
    snap_bucket, validate_row_block,
)
from .reconstruct import (  # noqa: F401
    LowRank, lstsq_svd, one_pass_reconstruct, reconstruction_error,
)
from .distributed import (  # noqa: F401
    ShardedStreamingSketch, corange_update, nystrom_finalize,
)
from .service import QOS_CLASSES, SketchService  # noqa: F401
from .ingest import IngestQueue, WorkerDied  # noqa: F401
from .wal import WalRecord, WriteAheadLog  # noqa: F401
from .wal import replay as wal_replay  # noqa: F401
from .elastic import drain_reshard_resume, reshard_stream  # noqa: F401
from . import faults  # noqa: F401
