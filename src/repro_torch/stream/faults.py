"""Fault-point registry: named hooks on the ingest hot path that tests arm
to inject failures (the registry half of the reference's
``stream/faults.py``).

  ``ingest.apply_round`` — fired by ``IngestQueue._apply`` before the fused
                           dispatch of each round.  Arm with
                           ``exc=WorkerKilled`` to simulate the worker
                           thread dying mid-round, or with a transient
                           exception to exercise retry/backoff.
  ``ingest.apply_lane``  — fired per lane inside the poison-excision
                           fallback; arm with ``match={"sid": s}`` to
                           poison exactly one tenant.

Fault points are zero-cost when disarmed: ``fire`` is a dict lookup
returning immediately.  Arming is per point with an optional budget
(``times``) and an optional context ``match``.  The reference's chaos
scenarios (kill-worker, torn-write, shrink-restore, eviction-storm) wait
for the port's recovery slice.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

_ARMED: Dict[str, "_Fault"] = {}
_LOCK = threading.Lock()


class FaultInjected(RuntimeError):
    """Default exception raised by an armed fault point."""


class WorkerKilled(BaseException):
    """Simulated hard crash of a worker thread.  Deliberately a
    BaseException: it must escape the per-round ``except Exception``
    error-recording path the same way a real kill would — the worker
    dies, it does not log-and-continue."""


class _Fault:
    def __init__(self, exc=None, handler=None, times=None, match=None):
        self.exc = exc
        self.handler = handler
        self.times = times            # None = unlimited
        self.match = dict(match or {})
        self.fired = 0

    def applies(self, ctx: Dict[str, Any]) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        return all(ctx.get(k) == v for k, v in self.match.items())


def arm(point: str, *, exc: Optional[type] = None,
        handler: Optional[Callable] = None,
        times: Optional[int] = 1,
        match: Optional[Dict[str, Any]] = None) -> None:
    """Arm ``point``.  Exactly one of ``exc`` (raised at the point) or
    ``handler`` (called with the point's context kwargs) fires per
    matching ``fire``; ``times=None`` keeps the fault armed forever."""
    if exc is None and handler is None:
        exc = FaultInjected
    with _LOCK:
        _ARMED[point] = _Fault(exc=exc, handler=handler, times=times,
                               match=match)


def disarm(point: str) -> None:
    with _LOCK:
        _ARMED.pop(point, None)


def clear() -> None:
    """Disarm everything (test teardown)."""
    with _LOCK:
        _ARMED.clear()


def armed(point: str) -> bool:
    return point in _ARMED


def fire(point: str, **ctx) -> None:
    """Hot-path hook: no-op unless ``point`` is armed and the context
    matches.  An armed ``exc`` is raised here; an armed ``handler`` runs
    here (exceptions it raises propagate)."""
    fault = _ARMED.get(point)
    if fault is None or not fault.applies(ctx):
        return
    fault.fired += 1
    if fault.handler is not None:
        fault.handler(**ctx)
        return
    raise fault.exc(f"chaos: fault injected at {point!r} ({ctx})")


def fire_count(point: str) -> int:
    fault = _ARMED.get(point)
    return 0 if fault is None else fault.fired
