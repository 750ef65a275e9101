"""Write-ahead ingest journal: crash-safe streaming updates (the port of
the reference's ``stream/wal.py``; the record format is the same, so a
journal written by either system replays into the other).

The sketch state (Y, W) is a *sum of deterministic per-slab updates*: given
``(seed, row0, H)`` the folded delta is a pure function (counter-based
Omega/Psi regeneration, core/rng.py), so a stream is fully reconstructible
from (a) its last durable checkpoint and (b) the ordered list of accepted
updates since.  The WAL makes (b) durable: every accepted request is
journaled — header plus raw H payload, CRC-sealed — *before* it is
dispatched to the device, and the journal is truncated as the applied
watermark advances.  Replay after a crash therefore reconstructs (Y, W)
**bitwise** (0 + x == x in IEEE-754 and each record re-runs the exact
update the live path would have run), which is the Tropp-linearity
argument of the reference's docs/FAULT_MODEL.md made executable.

Record format (little-endian, append-only):

    MAGIC(4s) | header_len(u32) | header(JSON) | payload | crc32(u32)

where the CRC covers ``header + payload``.  A torn tail — a record cut by
the crash, or one whose CRC no longer matches — is *discarded at the first
bad byte*: everything before it is intact by construction (appends are
flushed+fsynced before the submit returns), everything at/after it was
never acknowledged, so dropping it is exactly the at-most-once contract a
crashed server may honor.

``depth`` (records journaled but not yet applied) is published as the
``stream_wal_depth`` gauge; replays count into ``stream_replays_total``.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

_MAGIC = b"SWAL"
_HDR = struct.Struct("<4sI")      # magic, header_len
_CRC = struct.Struct("<I")


class WalRecord(NamedTuple):
    """One journaled update, exactly as accepted."""
    seqno: int
    sid: int
    row0: int
    H: np.ndarray

    @property
    def words(self) -> int:
        return int(self.H.size)


class TornRecord(NamedTuple):
    """Where and why a replay stopped early (the discarded torn tail)."""
    offset: int
    reason: str


def _encode(seqno: int, sid: int, row0: int, H: np.ndarray) -> bytes:
    payload = np.ascontiguousarray(H).tobytes()
    header = json.dumps({
        "seqno": int(seqno), "sid": int(sid), "row0": int(row0),
        "shape": list(H.shape), "dtype": H.dtype.name,
        "digest": zlib.crc32(payload) & 0xFFFFFFFF,
    }).encode()
    crc = zlib.crc32(payload, zlib.crc32(header)) & 0xFFFFFFFF
    return _HDR.pack(_MAGIC, len(header)) + header + payload + _CRC.pack(crc)


def scan(path: str) -> Tuple[List[WalRecord], Optional[TornRecord]]:
    """Decode every intact record of a journal file, in append order.

    Returns ``(records, torn)`` where ``torn`` is None for a clean file and
    otherwise names the offset and reason of the first bad byte — the
    point at which the decode stops (nothing after a torn record can be
    trusted to be aligned).
    """
    records: List[WalRecord] = []
    if not os.path.exists(path):
        return records, None
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        if len(data) - off < _HDR.size:
            return records, TornRecord(off, "truncated record header")
        magic, hlen = _HDR.unpack_from(data, off)
        if magic != _MAGIC:
            return records, TornRecord(off, "bad magic")
        end = off + _HDR.size + hlen
        if end + _CRC.size > len(data):
            return records, TornRecord(off, "truncated header")
        try:
            hdr = json.loads(data[off + _HDR.size:end])
            shape = tuple(int(x) for x in hdr["shape"])
            dtype = np.dtype(hdr["dtype"])
        except (ValueError, KeyError, TypeError):
            return records, TornRecord(off, "unparseable header")
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        pend = end + nbytes
        if pend + _CRC.size > len(data):
            return records, TornRecord(off, "truncated payload")
        payload = data[end:pend]
        (crc,) = _CRC.unpack_from(data, pend)
        want = zlib.crc32(payload,
                          zlib.crc32(data[off + _HDR.size:end])) & 0xFFFFFFFF
        if crc != want or (zlib.crc32(payload) & 0xFFFFFFFF) != hdr["digest"]:
            return records, TornRecord(off, "crc mismatch")
        H = np.frombuffer(payload, dtype).reshape(shape)
        records.append(WalRecord(int(hdr["seqno"]), int(hdr["sid"]),
                                 int(hdr["row0"]), H))
        off = pend + _CRC.size
    return records, None


class WriteAheadLog:
    """Append-only journal of accepted-but-maybe-unapplied updates.

    Thread-safe: ``append`` runs on submitter threads, ``mark_applied`` /
    ``truncate`` on the ingest worker.  Appends are flushed and fsynced
    before returning — an acknowledged submit is durable by the time the
    caller sees its seqno.

    Reopening an existing journal resumes the seqno sequence past what is
    durable, but the applied watermark restarts at 0 (the journal does
    not persist it — every surviving record is pending until proven
    applied).  Run :func:`replay` on the reopened log before attaching a
    new ``IngestQueue``: it re-applies the pending records AND advances
    the watermark past them, so the queue resumes with an accurate depth
    and ``truncate`` can drop the replayed prefix.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "ab")
        self._seq = 0
        self._applied = 0            # watermark: every seqno <= is applied
        # resume: continue the seqno sequence past what is already durable
        existing, torn = scan(path)
        if torn is not None:
            self._repair(existing)
        if existing:
            self._seq = existing[-1].seqno
        m = obs_metrics.get_metrics()
        self._m_depth = m.gauge(
            "stream_wal_depth",
            "journaled updates not yet covered by the applied watermark")
        self._m_depth.set(len(existing))

    # -- producer side -----------------------------------------------------

    def append(self, sid: int, row0: int, H) -> int:
        """Journal one accepted update; durable (fsync) before return.
        Returns the record's seqno."""
        H = np.asarray(H)
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._f.write(_encode(seq, sid, row0, H))
            self._f.flush()
            os.fsync(self._f.fileno())
            self._m_depth.set(seq - self._applied)
        return seq

    # -- applied-watermark advance ------------------------------------------

    def mark_applied(self, seqno: int) -> None:
        """Advance the applied watermark (monotone)."""
        with self._lock:
            if seqno > self._applied:
                self._applied = seqno
            self._m_depth.set(max(0, self._seq - self._applied))

    def truncate(self) -> int:
        """Drop every record at or below the applied watermark (atomic
        rewrite: survivors to a tmp file, ``os.replace`` into place).
        Returns the number of records still journaled."""
        with self._lock:
            self._f.close()
            records, _ = scan(self.path)
            keep = [r for r in records if r.seqno > self._applied]
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                for r in keep:
                    f.write(_encode(r.seqno, r.sid, r.row0, r.H))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._f = open(self.path, "ab")
            self._m_depth.set(len(keep))
            return len(keep)

    @property
    def depth(self) -> int:
        with self._lock:
            return max(0, self._seq - self._applied)

    @property
    def watermark(self) -> int:
        """Highest seqno such that every record at or below it is applied
        (or otherwise resolved — rejected / quarantined)."""
        with self._lock:
            return self._applied

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- crash recovery ------------------------------------------------------

    def _repair(self, intact: List[WalRecord]) -> None:
        """Rewrite the file to its intact prefix (drops the torn tail)."""
        self._f.close()
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            for r in intact:
                f.write(_encode(r.seqno, r.sid, r.row0, r.H))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")

    def pending(self) -> List[WalRecord]:
        """The records past the applied watermark, in append order (the
        replay set).  A torn tail is silently excluded — those records were
        never acknowledged."""
        records, _ = scan(self.path)
        with self._lock:
            applied = self._applied
        return [r for r in records if r.seqno > applied]


def replay(source, service, *, sid_map=None,
           watermark: int = 0) -> Tuple[int, int]:
    """Re-apply journaled updates to ``service`` in seqno order, each
    through ``service.update(sid, H, row0=row0)``.  A grid service takes
    full-shape additive updates only: its records apply as
    ``service.update(sid, H)``, as live grid ingest applied them, and a
    record journaled as a row slab (``row0 != 0``, from a local service)
    is refused rather than applied at row 0.

    ``source`` is a WAL path, a :class:`WriteAheadLog`, or an iterable of
    :class:`WalRecord`.  ``sid_map`` translates journaled sids onto the
    (re-opened) service's sids; ``watermark`` skips records already covered
    by the checkpoint the service was restored from.

    When ``source`` is a :class:`WriteAheadLog`, the applied watermark
    advances past every record replay handles (applied, or skipped as
    checkpoint-covered), so a queue attached after recovery resolves the
    pre-crash seqnos.

    Because each update is deterministic given ``(seed, row0, H)`` and a
    lane of the fused ingest is bitwise the solo update, the replayed
    (Y, W) is **bitwise** the state of the uninterrupted run.

    Returns ``(replayed_records, replayed_words)``.
    """
    wal = source if isinstance(source, WriteAheadLog) else None
    if wal is not None:
        records: Iterator[WalRecord] = iter(wal.pending())
    elif isinstance(source, str):
        records = iter(scan(source)[0])
    else:
        records = iter(source)
    grid = getattr(service, "mesh", None) is not None
    n = words = 0
    m = obs_metrics.get_metrics()
    replays = m.counter("stream_replays_total",
                        "WAL records re-applied after a crash")
    with obs_trace.span("stream.wal_replay", cat="stream"):
        for rec in records:
            if rec.seqno <= watermark:
                if wal is not None:
                    wal.mark_applied(rec.seqno)
                continue
            sid = rec.sid if sid_map is None else sid_map[rec.sid]
            if grid:
                if rec.row0 != 0:
                    raise ValueError(
                        f"WAL record seqno={rec.seqno} (stream {rec.sid}) "
                        f"is a row slab at row0={rec.row0}: distributed "
                        f"streams take full-shape additive updates only")
                service.update(sid, rec.H)
            else:
                service.update(sid, rec.H, row0=rec.row0)
            if wal is not None:
                wal.mark_applied(rec.seqno)
            n += 1
            words += rec.words
            replays.inc()
    return n, words
