"""The work a block of the port does, counted as it runs: FLOPs, device
bytes, collective bytes and kernel launches (the role of the reference's
``roofline/hlo.py`` and ``roofline/hlo_cost.py``, without an executable
to parse).

The reference walks a compiled program's HLO text.  The port runs
eagerly, so :func:`counting` counts a block's work from three sources:

  a. each hand-written kernel's dispatch counts its call once, from a
     pure shape function of this module (one a kernel), on the card and
     on the CPU alike: ``kernels/local.py``'s ``sketch_block``,
     ``sketch_t_block``, ``fold_rows_block``, ``gemm_block`` and the two
     bodies of ``sparse_fold_block``, and ``core.sketch.omega_tile``,
     where ``kernels.ops.gen_omega`` reaches K8.  While a dispatch runs,
     source b is suspended, so the plain version's torch ops on the CPU
     are never counted a second time;
  b. every other torch op, through a ``TorchDispatchMode``;
  c. the change of ``parallel.collectives.COMM`` and
     ``parallel.grad_compress.COMM`` across the block
     (``obs.ledger.comm_counters``).

What counts, as in ``hlo_cost``:

  * FLOPs: contractions only, 2·|out|·K for each GEMM — the kernels', and
    torch's ``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``addmv`` and
    ``dot`` (``matmul``, ``linear`` and the model's attention einsums
    reach these).  They are keyed by the dtype the contraction runs in:
    float32 for the kernels, which compute in f32 whatever they read, the
    operands' dtype for torch's.  Elementwise work, reductions, the sparse
    fold's scatter and the factorizations (QR, eigh, solves: one library
    call each, as the reference's custom calls) count 0.
  * device bytes: operand and output bytes at the granularity of a kernel
    launch or an aten op.  Views, ``empty*``, ``detach``, ``as_strided``
    and the other metadata ops count 0 (:data:`_SKIP_BYTES`, the
    counterpart of ``hlo_cost._SKIP_BYTES``); an ``out=`` argument, and
    the destination of ``copy_`` / ``fill_`` / ``zero_``, is written, not
    read; a broadcast (stride-0) dimension is read once.  An op's bytes
    are those of its tensors off the CPU; an op that touches only the
    CPU (a run on the CPU, or host bookkeeping) counts its CPU tensors.
    So a host-to-device copy counts what it writes on the card.
  * collective bytes: the words this rank receives, the port's ``COMM``
    convention, times :data:`WORD_BYTES`.  The reference's ``hlo.py`` sums
    each collective's operand sizes instead; the two agree only for a
    group of 2 (``parallel/collectives.py``).
  * launches: of each kernel, as ``kernels.sketch_matmul.LAUNCHES`` counts
    them on the card (the role of ``op_histogram``).

Outside :func:`counting` a dispatch's hook costs one global check.  A
block counts the work its own thread issues.  A hook that fails to count
raises; nothing is skipped.  The shape functions import the kernels'
plans when called: ``core.sketch`` imports this module, and the kernels
import ``core.sketch``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.obs.ledger import comm_counters, comm_since

#: Bytes of one counted word (the paper's f32 word; ``Cost.seconds``'s
#: ``itemsize``).
WORD_BYTES = 4

#: ``(thread id, WorkCounts)`` of every open :func:`counting` block.
_OPEN: List[tuple] = []
_TLS = threading.local()            # .depth: kernel dispatches running


@dataclasses.dataclass
class WorkCounts:
    """What one block counted (one rank's, for a distributed call)."""
    flops: float = 0.0
    flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, dtype: str, flops: float, nbytes: float) -> None:
        if flops:
            self.flops += flops
            self.flops_by_dtype[dtype] = (self.flops_by_dtype.get(dtype, 0.0)
                                          + flops)
        self.hbm_bytes += nbytes


def sum_counts(counts: Sequence[WorkCounts]) -> WorkCounts:
    """The fleet's counts: every field summed over the ranks' counts."""
    out = WorkCounts()
    for c in counts:
        for field in ("flops", "hbm_bytes", "collective_bytes"):
            setattr(out, field, getattr(out, field) + getattr(c, field))
        for field in ("flops_by_dtype", "collective_by_kind",
                      "collective_counts", "launches"):
            mine = getattr(out, field)
            for k, v in getattr(c, field).items():
                mine[k] = mine.get(k, 0) + v
    return out


# ---------------------------------------------------------------------------
# source a: one shape function a kernel
# ---------------------------------------------------------------------------

class Work(NamedTuple):
    """One kernel call: its launches, its f32 FLOPs, its device bytes."""
    launches: int
    flops: float
    nbytes: float


_NOTHING = Work(0, 0.0, 0.0)


def sketch_fwd_work(m: int, K: int, n: int, in_dtype, out_dtype,
                    accumulate: bool) -> Work:
    """``sketch_fwd`` of A (m, K) -> (m, n): 2·m·K·n FLOPs; A read once, the
    Omega scratch and (when split) the work buffer of ``sketch_fwd_plan``
    written once and read once, out written (read and written with
    ``acc``), as ``plan.model.hbm_roofline_words`` prices it."""
    if m == 0 or n == 0:
        return _NOTHING
    from repro_torch.kernels.sketch_matmul import sketch_fwd_plan
    plan = sketch_fwd_plan(m, n, K)
    out = (2 if accumulate else 1) * m * n * out_dtype.itemsize
    return Work(1, 2.0 * m * K * n,
                m * K * in_dtype.itemsize
                + 2 * (plan["scratch_bytes"] + plan["work_bytes"]) + out)


def sketch_t_work(m: int, K: int, n: int, in_dtype, out_dtype,
                  accumulate: bool) -> Work:
    """``sketch_t`` of B (K, n) -> (m, n): 2·m·K·n FLOPs; B read once, the
    Omega scratch and work buffer of ``sketch_t_plan`` written and read,
    out written (read and written with ``acc``)."""
    if m == 0 or n == 0:
        return _NOTHING
    from repro_torch.kernels.sketch_matmul import sketch_t_plan
    plan = sketch_t_plan(m, n, K)
    out = (2 if accumulate else 1) * m * n * out_dtype.itemsize
    return Work(1, 2.0 * m * K * n,
                K * n * in_dtype.itemsize
                + 2 * (plan["scratch_bytes"] + plan["work_bytes"]) + out)


def gemm_work(M: int, N: int, K: int, a_dtype, b_dtype, out_dtype,
              accumulate: bool) -> Work:
    """``gemm`` of (M, K)·(K, N): 2·M·N·K FLOPs; A and B read once, the
    split work buffer of ``gemm_plan`` written and read, out written (acc
    read too)."""
    if M == 0 or N == 0:
        return _NOTHING
    from repro_torch.kernels.sketch_matmul import gemm_plan
    out = (2 if accumulate else 1) * M * N * out_dtype.itemsize
    return Work(1, 2.0 * M * N * K,
                M * K * a_dtype.itemsize + K * N * b_dtype.itemsize
                + 2 * gemm_plan(M, N, K)["work_bytes"] + out)


def fold_rows_work(m: int, k: int, c: int, y_dtype, d_dtype,
                   starts: Sequence[int],
                   nvalids: Optional[Sequence[int]]) -> Work:
    """``fold_rows`` of len(starts) lanes: 0 FLOPs (an add).  Masked, a
    lane reads the d rows that feed its live rows and reads and writes
    those y rows; unmasked it rewrites all m rows of y and reads the d
    rows its window meets.  One launch a FOLD_LANE_CAPACITY lanes that
    change a row (``fold_rows_plan``)."""
    from repro_torch.kernels.sketch_matmul import FOLD_LANE_CAPACITY
    yb, db = c * y_dtype.itemsize, c * d_dtype.itemsize
    nbytes, spans = 0, []
    for i, s in enumerate(starts):
        if nvalids is None:
            fed = max(0, min(s + m, m + k) - max(s, m))
            nbytes += 2 * m * yb + fed * db
            spans.append(m)
        else:
            live = max(0, min(m, m + nvalids[i] - s) - max(0, m - s))
            nbytes += live * (2 * yb + db)
            spans.append(min(m, nvalids[i]))
    cap = FOLD_LANE_CAPACITY
    launches = sum(max(spans[a:a + cap]) > 0
                   for a in range(0, len(spans), cap))
    return Work(launches, 0.0, float(nbytes))


def sparse_fold_work(nseg: int, width: int, nnz: int, dtype,
                     table_rows: Optional[int], from_zero: bool) -> Work:
    """One S1 launch over ``nnz`` CSR-ordered entries into ``nseg``
    segments of ``width`` elements: 0 FLOPs (a scatter, as the reference's
    XLA scatter counts none); ``ptr``, the entry arrays (``val`` with
    ``src``, or ``cell`` with ``coef``) and the dense kinds' table read
    once, the accumulator read and written once.  Both are counted whole:
    ``from_zero`` writes every segment, and a slab of the port's density
    touches all but a few per cent of the others.  No launch when there
    is nothing to change."""
    if nseg * width == 0 or (nnz == 0 and not from_zero):
        return _NOTHING
    b = dtype.itemsize
    entries = nnz * (b + 4) if table_rows is not None else nnz * (4 + 2 * b)
    table = 0 if table_rows is None else table_rows * width * b
    return Work(1, 0.0, float(4 * (nseg + 1) + entries + table
                              + 2 * nseg * width * b))


def gen_omega_work(rows: int, cols: int, dtype) -> Work:
    """``gen_omega`` of a (rows, cols) f32 tile: 0 FLOPs, the tile written
    once; cast to ``dtype`` (read and written) when that is not f32."""
    n = rows * cols
    if n == 0:
        return _NOTHING
    cast = 0 if dtype == torch.float32 else n * (4 + dtype.itemsize)
    return Work(1, 0.0, float(4 * n + cast))


def kernel(name: str, work: Callable[..., Optional[Work]]):
    """Decorate a kernel dispatch: inside :func:`counting`, each call
    outside another dispatch adds ``work(*args, **kwargs)`` (a
    :class:`Work`, or None when the call runs no kernel: nothing counted,
    source b left on) under ``name`` to the thread's open blocks, and
    suspends source b while it runs.  Outside, one global check."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _OPEN or getattr(_TLS, "depth", 0):
                return fn(*args, **kwargs)
            return _counted(name, work(*args, **kwargs), fn, args, kwargs)
        return call
    return wrap


def _counted(name: str, w: Optional[Work], fn, args, kwargs):
    if w is None:
        return fn(*args, **kwargs)
    me = threading.get_ident()
    for tid, counts in _OPEN:
        if tid == me:
            counts.add("float32", w.flops, w.nbytes)
            if w.launches:
                counts.launches[name] = (counts.launches.get(name, 0)
                                         + w.launches)
    _TLS.depth = 1
    try:
        return fn(*args, **kwargs)
    finally:
        _TLS.depth = 0


# ---------------------------------------------------------------------------
# source b: every other torch op
# ---------------------------------------------------------------------------

def _mm(a, b):
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1], a.dtype


def _bmm(a, b):
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2], a.dtype


def _mv(a, v):
    return 2.0 * a.shape[0] * a.shape[1], a.dtype


def _dot(a, b):
    return 2.0 * a.shape[0], a.dtype


#: The contractions, by op name: (FLOPs, dtype) from their operands.
_FLOP_OPS = {
    "mm": lambda args: _mm(args[0], args[1]),
    "addmm": lambda args: _mm(args[1], args[2]),
    "bmm": lambda args: _bmm(args[0], args[1]),
    "baddbmm": lambda args: _bmm(args[1], args[2]),
    "mv": lambda args: _mv(args[0], args[1]),
    "addmv": lambda args: _mv(args[1], args[2]),
    "dot": lambda args: _dot(args[0], args[1]),
}

#: Ops that move no data (beside every view op, ``OpOverload.is_view``).
_SKIP_BYTES = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "detach_", "as_strided", "alias", "lift_fresh", "_unsafe_view",
    "_reshape_alias", "set_", "resize_", "record_stream"})

#: Ops whose first argument is written, not read.
_WRITE_ONLY = frozenset({"copy_", "fill_", "zero_"})


def _op_work(func, args, kwargs, out):
    """(FLOPs, dtype name, bytes) of one aten op."""
    name = func.overloadpacket.__name__
    flops, dtype = 0.0, None
    if name in _FLOP_OPS:
        flops, dtype = _FLOP_OPS[name](args)
        dtype = str(dtype).replace("torch.", "")
    if func.is_view or name in _SKIP_BYTES:
        return flops, dtype, 0
    reads = []
    for i, arg in enumerate(func._schema.arguments):
        if arg.is_out or (i == 0 and name in _WRITE_ONLY):
            continue
        reads.append(args[i] if i < len(args) else kwargs.get(arg.name))
    tensors = [t for t in tree_leaves(reads) + tree_leaves(out)
               if isinstance(t, torch.Tensor)]
    on_device = [t for t in tensors if t.device.type != "cpu"]
    return flops, dtype, sum(_nbytes(t) for t in on_device or tensors)


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the elements a tensor addresses: a broadcast (stride-0)
    dimension is read once, as an XLA fusion reads its unbroadcast
    operand."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride or size == 0:
            n *= size
    return n


class _OpCounter(TorchDispatchMode):
    """Source b: each aten op this thread runs, outside a kernel's
    dispatch, adds its contraction FLOPs and its bytes."""

    def __init__(self, counts: WorkCounts):
        super().__init__()
        self.counts = counts

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # The port compiles nothing, so no Dynamo frame needs skipping;
        # torch's default wraps __torch_dispatch__ in a Dynamo guard whose
        # first call imports torch._dynamo (seconds, in every process).
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch.is_inference_mode_enabled():
            # without autograd a composite op (matmul, einsum, linear)
            # reaches the mode whole: count the ops it decomposes into,
            # as outside inference mode
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not getattr(_TLS, "depth", 0):
            flops, dtype, nbytes = _op_work(func, args, kwargs, out)
            self.counts.add(dtype, flops, nbytes)
        return out


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def counting():
    """Count the work the block issues from this thread; yields the
    :class:`WorkCounts`, complete once the block has ended.  Blocks nest:
    each counts everything inside it."""
    counts = WorkCounts()
    entry = (threading.get_ident(), counts)
    before = comm_counters()
    _OPEN.append(entry)
    try:
        with _OpCounter(counts):
            yield counts
    finally:
        del _OPEN[next(i for i, e in enumerate(_OPEN) if e is entry)]
    words, calls = comm_since(before)
    for kind, w in words.items():
        counts.collective_by_kind[kind] = float(w * WORD_BYTES)
        counts.collective_counts[kind] = int(calls[kind])
        counts.collective_bytes += float(w * WORD_BYTES)
