"""repro_torch.obs — runtime observability: spans, metrics, and the comm
ledger (the reference's ``obs`` package).

Three instruments, one install pattern:

  * **metrics** (:mod:`.metrics`) — always-on process-global registry;
    counters/gauges/histograms with Prometheus text exposition.  The
    serving layer publishes into it unconditionally.
  * **tracer** (:mod:`.trace`) — span timeline with Chrome/Perfetto
    export; off by default (``span()`` is a shared no-op until
    ``install_tracer``).
  * **ledger** (:mod:`.ledger`) — per-call-site measured words (the
    port's collective counters around each dispatch) vs planner
    prediction vs the Theorem-2/3 floor; off by default
    (``install_ledger``).  ``report.honesty_report`` renders the audit;
    ``report.revalidate_autotune`` feeds drift back into the tuner cache.

The metrics registry and the tracer are copies of the reference's
pure-Python modules.  ``install_observability()`` turns everything on at
once (the serving launcher uses it behind ``--trace-out``).
"""
from .ledger import (CollectiveWords, CommLedger, LedgerSite, get_ledger,
                     install_ledger, observing, uninstall_ledger)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      get_metrics, set_metrics)
from .report import (drift_flags, honesty_report, report_rows,
                     revalidate_autotune)
from .trace import (SpanRecord, Tracer, current_span_id, get_tracer,
                    install_tracer, span, uninstall_tracer)

__all__ = [
    "CommLedger", "LedgerSite", "get_ledger", "install_ledger",
    "uninstall_ledger", "CollectiveWords", "observing",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_metrics",
    "set_metrics",
    "drift_flags", "honesty_report", "report_rows", "revalidate_autotune",
    "SpanRecord", "Tracer", "current_span_id", "get_tracer",
    "install_tracer", "span", "uninstall_tracer",
    "install_observability", "uninstall_observability",
]


def install_observability(max_spans: int = 100_000):
    """Install a fresh tracer + ledger (metrics are always on); returns
    ``(tracer, ledger, metrics)``."""
    return (install_tracer(Tracer(max_spans=max_spans)), install_ledger(),
            get_metrics())


def uninstall_observability():
    """Uninstall tracer and ledger; returns the previous ``(tracer,
    ledger)`` pair (the metrics registry stays installed)."""
    return uninstall_tracer(), uninstall_ledger()
