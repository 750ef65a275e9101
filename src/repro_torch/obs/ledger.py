"""CommLedger: runtime collective-word accounting against the paper's
bounds (the reference's ``obs/ledger.py``).

Each instrumented call site accumulates its call count, the words this
rank received in its collectives, the planner's predicted words and the
Theorem-2/3 floor, so that the audit the tests make (measured words equal
the closed forms) holds at run time too.

Two site flavors, as in the reference:

  * :meth:`CommLedger.observe` — a measured site.  The reference lowers
    the jitted ``fn`` and parses its HLO; the port has no executable to
    parse, so ``observe`` takes no ``fn``: the caller passes the words the
    dispatch received, by kind (``measured_words=``).  The context
    manager :func:`observing` wraps the dispatch and does this for the
    installed ledger: it reads ``parallel.collectives.COMM`` (every
    kind, ``redistribute`` included) and ``parallel.grad_compress.COMM``
    (the exchange's mean all-reduce, kind ``allreduce_mean``) before and
    after, and observes the difference.  The two counters never count one
    collective twice: ``grad_compress.allreduce_mean`` calls
    ``torch.distributed.all_reduce`` itself, not
    ``collectives.all_reduce``.  With no ledger installed,
    :func:`observing` returns a shared no-op after one ``None`` check;
    with one, the hot path costs the two counter reads and a dictionary
    lookup.
  * :meth:`CommLedger.record` — analytic only (``Plan.execute``, the
    sparse payload): predicted words, floor and wall time accumulate;
    measured words stay ``None``.

A site is keyed by (name, signature of its args' shapes and dtypes), so a
name keeps one site for each signature (``_sig_of``).  A rank's blocks
can have the same shapes on two grids, so the distributed sites pass
their grid among the args (the reference's global arrays carry it in
their sharding).  Each rank keeps its own ledger (the module-level one),
as each device did in the reference.

The word convention.  ``COMM`` counts the words THIS rank receives:
``(1 - 1/g)·numel(full)`` for an all-gather, a reduce-scatter (``full``
its input) and an all-to-all (``full`` its output), a ring's
``2·(1 - 1/g)·numel`` for an all-reduce, and for a Redistribute the
rank's destination block less what it already held; the exchange's
``allreduce_mean`` counts ``numel`` (the reference's unit for it).  The
reference's HLO audit counts each collective's per-device operand
instead; the two agree only in some places (an all-gather or an
all-reduce over a group of 2).  The port's ``plan/model.py`` prices in
``COMM``'s convention, so a site's drift is 0 wherever the model is
exact, whatever the group size.

Per-site audit figures (the reference's, mirroring
``plan.Plan.bound_ratio``):

  * ``bound_fraction`` — measured words a call over the Theorem-2/3
    floor (1.0 when both are zero: a regime-1 schedule meeting a zero
    floor with zero traffic is *at* the bound; ``inf`` when only the
    floor is zero);
  * ``drift`` — (measured - predicted) / predicted words, with the same
    zero rule.  Sites opened with an autotune ``cache_key`` feed
    ``obs.report.revalidate_autotune``.

Measured words a call are the site's words over its observed calls (a
site's calls move the same words wherever its signature fixes the
collectives, which is every site of the port).
"""
from __future__ import annotations

import math
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

#: ``parallel.collectives.KINDS`` (read through ``sys.modules``: the
#: observability package imports no collective module, which would import
#: the kernels and the models).
COLLECTIVE_KINDS = ("all_gather", "reduce_scatter", "all_reduce",
                    "all_to_all", "redistribute")
#: The kinds that change a layout rather than reduce or broadcast: the
#: §5.2 Redistribute and the 1-D Redist all-to-all.
REDISTRIBUTE_KINDS = ("all_to_all", "redistribute")
#: ``parallel.grad_compress.COMM``'s kind in a site's collectives.
EXCHANGE_KIND = "allreduce_mean"
_KINDS = COLLECTIVE_KINDS + (EXCHANGE_KIND,)
_COL = "repro_torch.parallel.collectives"
_GC = "repro_torch.parallel.grad_compress"
_NONE = (0, 0) * len(COLLECTIVE_KINDS)


def _sig_of(args: Tuple) -> Tuple:
    """Cheap structural signature of a call's args (shape/dtype per
    tensor; scalars and None verbatim) — the per-(site, signature) ledger
    key."""
    out = []
    for a in args:
        shape = getattr(a, "shape", None)
        if shape is not None:
            out.append((shape if type(shape) is tuple else tuple(shape),
                        getattr(a, "dtype", None)))
        else:
            out.append(a)
    return tuple(out)


def comm_counters() -> Tuple[float, ...]:
    """(words, calls) of every counted kind so far on this rank, in
    ``_KINDS`` order: ``collectives.COMM``'s kinds, then the exchange's (0
    while a module is not imported: nothing was counted there)."""
    col = sys.modules.get(_COL)
    if col is None:
        out = list(_NONE)
    else:
        out = []
        for kind in COLLECTIVE_KINDS:
            rec = col.COMM[kind]
            out += (rec["words"], rec["calls"])
    gc = sys.modules.get(_GC)
    if gc is None:
        out += (0, 0)
    else:
        out += (gc.COMM["words"], gc.COMM["calls"])
    return tuple(out)


def comm_since(before: Tuple[float, ...]) -> Tuple[Dict[str, float],
                                                   Dict[str, int]]:
    """The words and calls of each kind counted since ``before``
    (:func:`comm_counters`), kinds that moved nothing left out.  A
    counter reset in between reads as a negative delta and raises."""
    now = comm_counters()
    words, calls = {}, {}
    for i, kind in enumerate(_KINDS):
        w, c = now[2 * i] - before[2 * i], now[2 * i + 1] - before[2 * i + 1]
        if w < 0 or c < 0:
            raise RuntimeError(f"the {kind} counter was reset during an "
                               f"observed dispatch")
        if c:
            words[kind], calls[kind] = w, c
    return words, calls


@dataclass
class CollectiveWords:
    """Words this rank received in one call of a site, by kind (the role
    of the reference's ``roofline.hlo.CollectiveBytes``)."""
    by_kind: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, float] = field(default_factory=dict)

    @property
    def total(self) -> float:
        """Words a call, summed over every kind."""
        return float(sum(self.by_kind.values()))

    @property
    def redistribute_total(self) -> float:
        """Words a call of the layout-change kinds (the Redistribute and
        the all-to-all)."""
        return float(sum(self.by_kind.get(k, 0.0)
                         for k in REDISTRIBUTE_KINDS))

    def __repr__(self):
        kinds = ", ".join(f"{k}:{v:.6g}w x{self.counts.get(k, 0):g}"
                          for k, v in sorted(self.by_kind.items()))
        return (f"CollectiveWords(total={self.total:.6g}, "
                f"{kinds or 'none'})")


class LedgerSite:
    """One (call-site name, signature) accumulator."""

    def __init__(self, name: str, sig: Tuple, *,
                 predicted_words: float = 0.0,
                 lower_bound_words: float = 0.0,
                 itemsize: int = 4,
                 cache_key: Optional[str] = None,
                 measured: bool = True):
        self.name = name
        self.sig = sig
        self.predicted_words = float(predicted_words)
        self.lower_bound_words = float(lower_bound_words)
        self.itemsize = int(itemsize)
        self.cache_key = cache_key
        self.calls = 0
        self.wall_s = 0.0
        self._measured = measured
        self._observed = 0                  # calls behind the sums below
        self._words: Dict[str, float] = {}
        self._counts: Dict[str, float] = {}

    def _add(self, words: Dict[str, float], counts: Dict[str, float],
             calls: int) -> None:
        for k, w in words.items():
            self._words[k] = self._words.get(k, 0.0) + w
        for k, c in counts.items():
            self._counts[k] = self._counts.get(k, 0) + c
        self._observed += calls

    # -- measured words -----------------------------------------------------

    def collectives(self) -> Optional[CollectiveWords]:
        """Words a call by kind (None for analytic-only sites)."""
        if not self._measured:
            return None
        n = max(self._observed, 1)
        return CollectiveWords({k: w / n for k, w in self._words.items()},
                               {k: c / n for k, c in self._counts.items()})

    @property
    def measured_words(self) -> Optional[float]:
        """Words received over every observed call."""
        return (float(sum(self._words.values())) if self._measured
                else None)

    @property
    def measured_bytes_per_call(self) -> Optional[float]:
        cw = self.collectives()
        return None if cw is None else cw.total * self.itemsize

    @property
    def measured_bytes(self) -> Optional[float]:
        per = self.measured_bytes_per_call
        return None if per is None else per * self.calls

    @property
    def measured_words_per_call(self) -> Optional[float]:
        per = self.measured_bytes_per_call
        return None if per is None else per / self.itemsize

    # -- audit figures ------------------------------------------------------

    @property
    def bound_fraction(self) -> Optional[float]:
        """Measured words/call over the Theorem-2/3 floor; the zero/zero
        convention matches ``plan.Plan.bound_ratio``."""
        m = self.measured_words_per_call
        if m is None:
            return None
        if self.lower_bound_words == 0.0:
            return 1.0 if m == 0.0 else math.inf
        return m / self.lower_bound_words

    @property
    def drift(self) -> Optional[float]:
        """(measured - predicted) / predicted words per call."""
        m = self.measured_words_per_call
        if m is None:
            return None
        if self.predicted_words == 0.0:
            return 0.0 if m == 0.0 else math.inf
        return (m - self.predicted_words) / self.predicted_words

    def __repr__(self):
        m = self.measured_bytes_per_call
        return (f"LedgerSite({self.name!r}, calls={self.calls}, "
                f"bytes/call={'n/a' if m is None else f'{m:.6g}'}, "
                f"predicted_words={self.predicted_words:.6g}, "
                f"floor={self.lower_bound_words:.6g})")


class _Observation:
    """The context of one observed dispatch (:func:`observing`); ``site``
    is the site it accounted, once the dispatch has returned."""

    __slots__ = ("_ledger", "_name", "_args", "_kw", "_before", "_t0",
                 "site")

    def __init__(self, ledger, name, args, kw):
        self._ledger, self._name, self._args, self._kw = (ledger, name, args,
                                                          kw)
        self.site = None

    def __enter__(self):
        self._before = comm_counters()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        wall = time.perf_counter() - self._t0
        if exc_type is None:
            words, calls = comm_since(self._before)
            self.site = self._ledger.observe(
                self._name, self._args, measured_words=words,
                measured_calls=calls, wall_s=wall, **self._kw)
        return False


class _NoObservation:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


#: What :func:`observing` returns while no ledger is installed.
NO_OBSERVATION = _NoObservation()


class CommLedger:
    """Accumulates :class:`LedgerSite`s across every instrumented path."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sites: Dict[Tuple, LedgerSite] = {}

    # -- hot-path API -------------------------------------------------------

    def observe(self, name: str, args: Tuple, *,
                measured_words: Optional[Dict[str, float]] = None,
                measured_calls: Optional[Dict[str, int]] = None,
                predicted_words: float = 0.0,
                lower_bound_words: float = 0.0,
                itemsize: int = 4,
                cache_key: Optional[str] = None,
                wall_s: Optional[float] = None,
                count: int = 1) -> LedgerSite:
        """Account ``count`` dispatches, with args ``args``, that received
        ``measured_words`` (``{kind: words}``) in all, in
        ``measured_calls`` (``{kind: collective calls}``), as
        :func:`comm_since` gives them."""
        sig = _sig_of(args)
        key = (name, sig)
        site = self._sites.get(key)
        if site is None:
            site = LedgerSite(name, sig, predicted_words=predicted_words,
                              lower_bound_words=lower_bound_words,
                              itemsize=itemsize, cache_key=cache_key)
            with self._lock:
                site = self._sites.setdefault(key, site)
        site._add(measured_words or {}, measured_calls or {}, count)
        site.calls += count
        if wall_s is not None:
            site.wall_s += wall_s
        return site

    def record(self, name: str, *,
               predicted_words: float = 0.0,
               lower_bound_words: float = 0.0,
               itemsize: int = 4,
               cache_key: Optional[str] = None,
               wall_s: Optional[float] = None,
               detail: Any = None,
               count: int = 1) -> LedgerSite:
        """Analytic-only site (no measured words): predictions, floor and
        wall time accumulate; measured words stay unavailable."""
        key = (name, ("analytic", detail))
        site = self._sites.get(key)
        if site is None:
            site = LedgerSite(name, key[1],
                              predicted_words=predicted_words,
                              lower_bound_words=lower_bound_words,
                              itemsize=itemsize, cache_key=cache_key,
                              measured=False)
            with self._lock:
                site = self._sites.setdefault(key, site)
        site.calls += count
        if wall_s is not None:
            site.wall_s += wall_s
        return site

    # -- queries ------------------------------------------------------------

    def sites(self):
        with self._lock:
            return list(self._sites.values())

    def site(self, name: str) -> Optional[LedgerSite]:
        """The single site registered under ``name`` (first match)."""
        for s in self.sites():
            if s.name == name:
                return s
        return None

    def total_measured_bytes(self, name: Optional[str] = None) -> float:
        """Measured bytes summed over calls (and, with ``name``, restricted
        to that site name) — analytic-only sites contribute nothing."""
        tot = 0.0
        for s in self.sites():
            if name is not None and s.name != name:
                continue
            b = s.measured_bytes
            if b is not None:
                tot += b
        return tot

    def clear(self) -> None:
        with self._lock:
            self._sites.clear()

    def __len__(self):
        return len(self._sites)


# -- module-level install point ----------------------------------------------

_ledger: Optional[CommLedger] = None


def get_ledger() -> Optional[CommLedger]:
    return _ledger


def install_ledger(ledger: Optional[CommLedger] = None) -> CommLedger:
    global _ledger
    _ledger = ledger if ledger is not None else CommLedger()
    return _ledger


def uninstall_ledger() -> Optional[CommLedger]:
    global _ledger
    prev, _ledger = _ledger, None
    return prev


def observing(name: str, args: Tuple, audit=None, audit_args: Tuple = (),
              **kw):
    """Context manager around one dispatch, for the installed ledger:
    :data:`NO_OBSERVATION` when none is installed; else it observes the
    words ``COMM`` counted inside the dispatch and its host wall time,
    with ``predicted_words`` and ``lower_bound_words`` from
    ``audit(*audit_args)`` when ``audit`` is given (evaluated only then);
    the other keywords are :meth:`CommLedger.observe`'s."""
    led = _ledger
    if led is None:
        return NO_OBSERVATION
    if audit is not None:
        kw["predicted_words"], kw["lower_bound_words"] = audit(*audit_args)
    return _Observation(led, name, args, kw)
