"""Dependency-free counter / gauge / histogram registry (a copy of the
reference's ``obs/metrics.py``, which is pure Python).

The serving layer (``stream/service.py``, ``stream/ingest.py``,
``stream/wal.py``) publishes into a process-global default registry —
always on, because the publish path is a dict lookup plus a float add and
the registry never allocates on the hot path after the first observation
of a (metric, labelset).  ``prometheus_text`` renders the standard text
exposition (``launch/serve.py --metrics`` dumps it); ``snapshot`` returns
plain dicts for tests and dashboards.

No prometheus_client, no numpy: histograms keep cumulative bucket counts
(Prometheus ``le`` semantics) plus a bounded window of raw values so the
queue's p50/p99 tail latencies stay exact, not bucket-quantized.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

# default latency-ish buckets (seconds); callers pass their own for counts
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_RAW_WINDOW = 8192          # raw-value window cap per (histogram, labelset)


def _labelkey(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _labelstr(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def _header(self) -> str:
        out = []
        if self.help:
            out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.kind}")
        return "\n".join(out)


class Counter(_Metric):
    """Monotonically increasing count, optionally labelled."""
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._vals: Dict[Tuple, float] = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        k = _labelkey(labels)
        with self._lock:
            self._vals[k] = self._vals.get(k, 0.0) + value

    def value(self, **labels) -> float:
        return self._vals.get(_labelkey(labels), 0.0)

    def snapshot(self):
        return {_labelstr(k) or "": v for k, v in self._vals.items()}

    def expose(self) -> str:
        lines = [self._header()]
        for k, v in sorted(self._vals.items()):
            lines.append(f"{self.name}{_labelstr(k)} {_fmt(v)}")
        if not self._vals:
            lines.append(f"{self.name} 0")
        return "\n".join(lines)


class Gauge(_Metric):
    """A value that can go up and down (queue depth, resident streams)."""
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._vals: Dict[Tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._vals[_labelkey(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        k = _labelkey(labels)
        with self._lock:
            self._vals[k] = self._vals.get(k, 0.0) + value

    def dec(self, value: float = 1.0, **labels) -> None:
        self.inc(-value, **labels)

    def value(self, **labels) -> float:
        return self._vals.get(_labelkey(labels), 0.0)

    def snapshot(self):
        return {_labelstr(k) or "": v for k, v in self._vals.items()}

    def expose(self) -> str:
        lines = [self._header()]
        for k, v in sorted(self._vals.items()):
            lines.append(f"{self.name}{_labelstr(k)} {_fmt(v)}")
        if not self._vals:
            lines.append(f"{self.name} 0")
        return "\n".join(lines)


class _HistState:
    __slots__ = ("bucket_counts", "count", "total", "window")

    def __init__(self, nbuckets: int):
        self.bucket_counts = [0] * nbuckets
        self.count = 0
        self.total = 0.0
        self.window = []            # bounded raw values for exact quantiles


class Histogram(_Metric):
    """Cumulative-bucket histogram plus an exact bounded quantile window."""
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._states: Dict[Tuple, _HistState] = {}

    def observe(self, value: float, **labels) -> None:
        k = _labelkey(labels)
        with self._lock:
            st = self._states.get(k)
            if st is None:
                st = self._states[k] = _HistState(len(self.buckets))
            i = bisect.bisect_left(self.buckets, value)
            if i < len(self.buckets):
                st.bucket_counts[i] += 1
            st.count += 1
            st.total += value
            st.window.append(value)
            if len(st.window) > _RAW_WINDOW:
                del st.window[: _RAW_WINDOW // 2]

    def count(self, **labels) -> int:
        st = self._states.get(_labelkey(labels))
        return 0 if st is None else st.count

    def percentile(self, q: float, **labels) -> float:
        """Exact q-th percentile over the retained raw-value window
        (0.0 on an empty window — never an exception)."""
        st = self._states.get(_labelkey(labels))
        if st is None or not st.window:
            return 0.0
        xs = sorted(st.window)
        if len(xs) == 1:
            return xs[0]
        # linear interpolation, numpy.percentile's default method
        pos = (len(xs) - 1) * min(max(q, 0.0), 100.0) / 100.0
        lo = int(pos)
        frac = pos - lo
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def reset_window(self, **labels) -> None:
        st = self._states.get(_labelkey(labels))
        if st is not None:
            st.window.clear()

    def snapshot(self):
        out = {}
        for k, st in self._states.items():
            out[_labelstr(k) or ""] = {
                "count": st.count, "sum": st.total,
                "p50": self.percentile(50, **dict(k)),
                "p99": self.percentile(99, **dict(k))}
        return out

    def expose(self) -> str:
        lines = [self._header()]
        for k, st in sorted(self._states.items()):
            cum = 0
            for b, c in zip(self.buckets, st.bucket_counts):
                cum += c
                lk = dict(k)
                lk["le"] = _fmt(b)
                lines.append(f"{self.name}_bucket{_labelstr(_labelkey(lk))} "
                             f"{cum}")
            lk = dict(k)
            lk["le"] = "+Inf"
            lines.append(f"{self.name}_bucket{_labelstr(_labelkey(lk))} "
                         f"{st.count}")
            lines.append(f"{self.name}_sum{_labelstr(k)} {_fmt(st.total)}")
            lines.append(f"{self.name}_count{_labelstr(k)} {st.count}")
        if not self._states:
            lines.append(f"{self.name}_count 0")
        return "\n".join(lines)


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class MetricsRegistry:
    """Named metrics, create-on-first-use; thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, name: str, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        m = self._get(name, lambda: Counter(name, help))
        if not isinstance(m, Counter):
            raise TypeError(f"{name!r} is a {m.kind}, not a counter")
        return m

    def gauge(self, name: str, help: str = "") -> Gauge:
        m = self._get(name, lambda: Gauge(name, help))
        if not isinstance(m, Gauge):
            raise TypeError(f"{name!r} is a {m.kind}, not a gauge")
        return m

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        m = self._get(name, lambda: Histogram(name, help, buckets))
        if not isinstance(m, Histogram):
            raise TypeError(f"{name!r} is a {m.kind}, not a histogram")
        return m

    def names(self) -> Iterable[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, object]:
        return {name: self._metrics[name].snapshot()
                for name in self.names()}

    def prometheus_text(self) -> str:
        """Standard Prometheus text exposition of every metric."""
        blocks = [self._metrics[name].expose() for name in self.names()]
        return "\n".join(blocks) + ("\n" if blocks else "")

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


# -- process-global default registry ----------------------------------------

_default = MetricsRegistry()


def get_metrics() -> MetricsRegistry:
    """The process-global registry every instrumented path publishes to."""
    return _default


def set_metrics(registry: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Swap the global registry (tests isolate by installing a fresh one);
    returns the previous registry.  ``None`` installs a fresh empty one."""
    global _default
    prev = _default
    _default = registry if registry is not None else MetricsRegistry()
    return prev
