"""Thread-safe span tracer with Chrome/Perfetto ``trace_event`` export (a
copy of the reference's ``obs/trace.py``, which is pure Python).

One serving run produces a timeline of ingest -> bucket -> fused update ->
finalize: every instrumented path opens spans through the module-level
:func:`span` helper, which is a shared no-op context manager while no
tracer is installed — the uninstrumented hot path pays one global read.

Cross-thread parenting: spans nest per-thread via a ``threading.local``
stack, and a span may be opened with an explicit ``parent=`` id — the
``IngestQueue`` worker stitches its apply spans under the submitting
request's span this way (capture ``current_span_id()`` at submit, pass it
through the queue).

Export: :meth:`Tracer.export_chrome` writes the Chrome ``trace_event``
JSON array format (complete "X" events, microsecond timestamps), loadable
in ``chrome://tracing`` / Perfetto; :meth:`Tracer.to_chrome_events`
returns the event dicts for tests.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import threading
import time
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class SpanRecord:
    """One closed span (monotonic clock, ns)."""
    name: str
    cat: str
    start_ns: int
    dur_ns: int
    tid: int
    span_id: int
    parent_id: Optional[int]
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


class _SpanCtx:
    __slots__ = ("_tracer", "name", "cat", "args", "parent",
                 "span_id", "_t0", "_explicit_parent")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 parent: Optional[int], args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._explicit_parent = parent
        self.parent = None
        self.span_id = None
        self._t0 = 0

    def __enter__(self):
        t = self._tracer
        self.span_id = next(t._ids)
        stack = t._stack()
        self.parent = (self._explicit_parent
                       if self._explicit_parent is not None
                       else (stack[-1] if stack else None))
        stack.append(self.span_id)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self._t0
        t = self._tracer
        stack = t._stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        t._record(SpanRecord(
            name=self.name, cat=self.cat, start_ns=self._t0, dur_ns=dur,
            tid=threading.get_ident(), span_id=self.span_id,
            parent_id=self.parent, args=self.args))
        return False


class Tracer:
    """Collects :class:`SpanRecord`s; bounded, thread-safe."""

    def __init__(self, max_spans: int = 100_000):
        self.max_spans = int(max_spans)
        self._spans: List[SpanRecord] = []
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self.dropped = 0

    # -- recording ----------------------------------------------------------

    def _stack(self) -> List[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
                return
            self._spans.append(rec)

    def span(self, name: str, cat: str = "", parent: Optional[int] = None,
             **args) -> _SpanCtx:
        """Context manager opening a span; nests under the thread's current
        span unless ``parent=`` pins it explicitly (cross-thread)."""
        return _SpanCtx(self, name, cat, parent, args)

    def trace(self, name: Optional[str] = None, cat: str = ""):
        """Decorator form: ``@tracer.trace("my.op")``."""
        def deco(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                with self.span(label, cat=cat):
                    return fn(*a, **kw)
            return wrapper
        return deco

    def current_span_id(self) -> Optional[int]:
        """Id of this thread's innermost open span (None outside spans) —
        capture at submit time to parent work done on another thread."""
        st = self._stack()
        return st[-1] if st else None

    # -- introspection / export ---------------------------------------------

    @property
    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def to_chrome_events(self) -> List[dict]:
        """Chrome ``trace_event`` complete ("X") events, microseconds."""
        events = []
        for s in self.spans:
            args = dict(s.args)
            args["span_id"] = s.span_id
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            events.append({
                "name": s.name, "cat": s.cat or "repro", "ph": "X",
                "ts": s.start_ns / 1e3, "dur": s.dur_ns / 1e3,
                "pid": 0, "tid": s.tid, "args": args})
        return events

    def export_chrome(self, path: str) -> str:
        """Write the Chrome/Perfetto JSON trace; returns ``path``."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.to_chrome_events(),
                       "displayTimeUnit": "ms"}, f)
        return path


# -- module-level install point (the hot-path fast path) ---------------------

_tracer: Optional[Tracer] = None

# one shared reusable no-op context manager: `with span(...)` costs a
# global read + a function call when tracing is off
_NULL = contextlib.nullcontext()


def get_tracer() -> Optional[Tracer]:
    return _tracer


def install_tracer(tracer: Optional[Tracer] = None) -> Tracer:
    """Install (and return) the process-global tracer; ``None`` makes a
    fresh one."""
    global _tracer
    _tracer = tracer if tracer is not None else Tracer()
    return _tracer


def uninstall_tracer() -> Optional[Tracer]:
    """Remove the global tracer (spans become no-ops); returns it."""
    global _tracer
    prev, _tracer = _tracer, None
    return prev


def span(name: str, cat: str = "", parent: Optional[int] = None, **args):
    """Module-level span helper: a real span when a tracer is installed,
    the shared no-op context manager otherwise."""
    t = _tracer
    if t is None:
        return _NULL
    return t.span(name, cat=cat, parent=parent, **args)


def current_span_id() -> Optional[int]:
    t = _tracer
    return None if t is None else t.current_span_id()
